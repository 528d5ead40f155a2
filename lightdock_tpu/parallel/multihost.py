"""Multi-swarm / multi-host orchestration.

The reference farms swarms out as independent OS processes from a task
list (reference example/1czy/execution.sh:21-24, one process per
initial_positions_N.dat).  Here swarms are a batch axis: S swarms run in
one jitted program, sharded over the mesh's ``swarm`` axis — one chip runs
many swarms at once, a pod slice runs S/devices each, and multiple hosts
cooperate through ``jax.distributed`` with zero cross-swarm traffic
(the algorithm has none; SURVEY §5).

Every swarm uses the same RNG stream (the reference seeds every swarm
process with the same setup.json seed, reference src/lib.rs:38).
"""

from __future__ import annotations

import os
import pathlib
from typing import List, Sequence

import jax
import numpy as np

from ..engine.gso_jax import SwarmState, init_state
from ..utils.rng import uniform_f64_stream


def maybe_initialize_distributed() -> bool:
    """Initialise jax.distributed from standard env vars when present.

    Uses JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    Returns True when running multi-process.
    """
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
        return True
    return jax.process_count() > 1


def stack_swarm_states(positions_list: Sequence[np.ndarray], use_anm: bool,
                       anm_rec: int, anm_lig: int, dtype) -> SwarmState:
    """Batch S swarms' initial positions into one leading-axis state."""
    states = [init_state(p, use_anm, anm_rec, anm_lig, dtype=dtype)
              for p in positions_list]
    return jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs), *states)


def swarm_randoms(seed: int, steps: int, n_swarms: int, g: int,
                  start_step: int = 0) -> np.ndarray:
    """(steps, S, G) uniform draws; identical stream per swarm (matching
    the reference's per-process seeding)."""
    r = uniform_f64_stream(seed, steps * g)[start_step * g:]
    r = r.reshape(-1, g)
    return np.broadcast_to(r[:, None, :], (r.shape[0], n_swarms, g)).copy()


def _addressable_swarms(outs, swarm_axis: int, n: int) -> set:
    """Swarm indices whose data this process can fetch (multi-host runs
    shard the swarm axis across hosts; each host writes only its own)."""
    leaf = jax.tree_util.tree_leaves(outs)[0]
    sharding = getattr(leaf, "sharding", None)
    if sharding is None or sharding.is_fully_addressable:
        return set(range(n))
    owned = set()
    for shard in leaf.addressable_shards:
        idx = shard.index[swarm_axis]
        start = idx.start or 0
        stop = idx.stop if idx.stop is not None else n
        owned.update(range(start, min(stop, n)))
    return owned


def _swarm_local(x, s_idx: int, swarm_axis: int) -> np.ndarray:
    """Fetch one swarm's slice of a (possibly cross-process) global array.

    Indexing a non-fully-addressable array outside jit is unsafe (observed
    to double-count contributions across processes); go through the
    process-local shards instead.  Returns the slice with the swarm axis
    removed, steps axis leading.
    """
    sharding = getattr(x, "sharding", None)
    if sharding is None or sharding.is_fully_addressable:
        arr = np.asarray(x)
        return arr[s_idx] if swarm_axis == 0 else arr[:, s_idx]
    for shard in x.addressable_shards:
        idx = shard.index[swarm_axis]
        start = idx.start or 0
        stop = idx.stop if idx.stop is not None else x.shape[swarm_axis]
        if start <= s_idx < stop:
            data = np.asarray(shard.data)
            local = s_idx - start
            return data[local] if swarm_axis == 0 else data[:, local]
    raise KeyError(f"swarm {s_idx} not addressable from this process")


def write_swarm_outputs(outs, swarm_ids: List[int], use_anm: bool,
                        steps: int, output_root=".", start_step: int = 0,
                        swarm_axis: int = 1, sidecars: bool = False) -> None:
    """Write swarm_N/gso_step.out files from stacked StepOutput.

    ``outs`` leaves are (steps, S, ...) (or (S, steps, ...) with
    swarm_axis=0).  In multi-process runs each host only writes swarms it
    can address.  ``sidecars`` additionally writes the full-precision
    ``.npz`` state next to each snapshot (bit-exact resume).
    """
    from ..utils.output import write_gso_output, write_state_sidecar

    root = pathlib.Path(output_root)
    addressable = _addressable_swarms(outs, swarm_axis, len(swarm_ids))
    for s_idx, swarm_id in enumerate(swarm_ids):
        if s_idx not in addressable:
            continue  # another host owns (and writes) this swarm's shard
        outdir = root / f"swarm_{swarm_id}"
        # Per-swarm local views (steps leading), fetched via process-local
        # shards — see _swarm_local.
        local = {name: _swarm_local(getattr(outs, name), s_idx, swarm_axis)
                 for name in outs._fields}

        first = True
        for step in range(start_step + 1, steps + 1):
            if not (step % 10 == 0 or step == 1):
                continue
            i = step - 1 - start_step
            if first:
                outdir.mkdir(parents=True, exist_ok=True)
                first = False
            cols = [local["t"][i], local["q"][i]]
            if use_anm and local["a_rec"].shape[-1] > 0:
                cols.append(local["a_rec"][i])
            if use_anm and local["a_lig"].shape[-1] > 0:
                cols.append(local["a_lig"][i])
            poses = np.concatenate(cols, axis=1).astype(np.float64)
            path = outdir / f"gso_{step}.out"
            write_gso_output(path, poses,
                             local["luciferin"][i].astype(np.float64),
                             local["num_neighbors"][i],
                             local["vision"][i].astype(np.float64),
                             local["scoring"][i].astype(np.float64))
            if sidecars:
                from ..engine.gso_jax import SwarmState
                write_state_sidecar(path, step,
                                    **{k: local[k][i]
                                       for k in SwarmState._fields})


# run_swarm_farm lives in parallel.farm (SwarmFarmRunner: flat-batched
# energy over all swarms, params uploaded once, segments + sidecars).
