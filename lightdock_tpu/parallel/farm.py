"""Production multi-swarm farm: S swarms, one device program, any energy path.

The reference farms swarms out as independent OS processes (reference
example/1czy/execution.sh:21-24).  Here the farm is a single jitted scan:

- Energy is computed for ALL swarms in one flat (S*G)-pose call, so the
  pair energy (fused XLA or the culled DFIRE kernel) sees one large pose
  batch per step instead of S small ones — that is what fills the device
  (swarm-axis vmap of the energy would relaunch the kernel per swarm and
  pay its fixed cost S times).
- Movement/neighbor phases are per-swarm (the algorithm has no cross-swarm
  interaction, reference src/swarm.rs:86-102) and run under vmap.
- On multi-device meshes the swarm axis is sharded with shard_map: each
  device flattens only its local swarms; there is zero cross-device
  traffic during optimization.

Parameters are uploaded to the device(s) once at construction, not per
run call (the DFIRE dq tensor alone is 30 MB at the 1ppe shape).
"""

from __future__ import annotations

import functools
import pathlib
import re
import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..engine.energy_batch import BatchScoringParams
from ..engine.gso_jax import (SwarmState, batch_energy_chunked, device_params,
                              gso_step, pick_energy_mode)
from .mesh import SWARM_AXIS, make_mesh, replicate_params, shard_swarm_states
from .multihost import stack_swarm_states, swarm_randoms, write_swarm_outputs


def make_farm_step(energy_fn_flat):
    """One GSO step for S stacked swarms: flat-batched energy over the
    (S*G) pose axis, then per-swarm movement under vmap.

    ``energy_fn_flat(params, t, q, a_rec, a_lig) -> (N,)`` scores N poses
    (N = S*G); states leaves carry a leading swarm axis.
    """

    def step(params, states: SwarmState, randoms):
        s, g = states.t.shape[0], states.t.shape[1]
        scores = energy_fn_flat(
            params,
            states.t.reshape(s * g, 3),
            states.q.reshape(s * g, 4),
            states.a_rec.reshape(s * g, -1),
            states.a_lig.reshape(s * g, -1),
            # moved||step==0 rescoring gate (reference src/glowworm.rs:62):
            # the kernel path skips unmoved poses, XLA ignores it.
            moved=(states.num_neighbors > 0).reshape(s * g),
            prev_scoring=states.scoring.reshape(s * g),
        ).reshape(s, g)

        def move(st, r, sc):
            return gso_step(params, st, r, energy_fn=lambda *a, **k: sc)

        return jax.vmap(move)(states, randoms, scores)

    return step


class SwarmFarmRunner:
    """Host wrapper for the farm: uploads params once, scans segments,
    writes per-swarm snapshots (+ full-precision sidecars), resumes.

    Mirrors ``GsoJaxRunner`` for the S-swarm case; supports every energy
    mode the single-swarm runner does (``auto``/``xla``/``pallas``).
    """

    def __init__(self, params: BatchScoringParams,
                 positions_list: Sequence[np.ndarray],
                 swarm_ids: Sequence[int], seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 dtype=jnp.float32, output_root=".",
                 energy_mode: str = "auto", energy_chunk: int = 0,
                 cull: bool = True, devices: Optional[Sequence] = None,
                 interpret: bool = False):
        from ..utils.rng import uniform_f64_stream

        self.swarm_ids = list(swarm_ids)
        self.n_swarms = len(positions_list)
        self.use_anm = use_anm
        self.output_root = output_root
        self.seed = seed
        self.dtype = dtype
        self._stream = functools.partial(uniform_f64_stream, seed)
        self._start_step = 0

        devices = list(devices if devices is not None else jax.devices())
        n_dev = min(len(devices), self.n_swarms)
        self.mesh = make_mesh(n_swarm=n_dev, n_atoms=1, devices=devices)

        # Pad the swarm batch to a multiple of the device count (padding
        # swarms replay swarm 0 and are never written out).
        pad = (-self.n_swarms) % n_dev
        self._padded = list(positions_list) + [positions_list[0]] * pad

        if energy_mode == "auto":
            energy_mode = pick_energy_mode(params)
        self.energy_mode = energy_mode
        if energy_mode == "pallas":
            from ..engine.energy_pallas import (make_pallas_energy_fn,
                                                spatial_sort_params)
            params = spatial_sort_params(params)
            energy_fn = make_pallas_energy_fn(params, cull=cull,
                                              interpret=interpret)
        elif energy_mode == "xla":
            energy_fn = functools.partial(batch_energy_chunked,
                                          chunk=energy_chunk)
        else:
            raise ValueError(f"unknown energy_mode {energy_mode!r}")

        self.params = replicate_params(
            self.mesh, device_params(params, dtype=dtype))
        self.states = shard_swarm_states(
            self.mesh,
            stack_swarm_states(self._padded, use_anm, anm_rec, anm_lig, dtype))
        self._initial_states = self.states
        self._randoms_sharding = jax.sharding.NamedSharding(
            self.mesh, P(None, SWARM_AXIS))

        step = make_farm_step(energy_fn)

        def seg_body(p, states, randoms):
            return jax.lax.scan(functools.partial(step, p), states, randoms)

        if self.mesh.devices.size > 1:
            # Prefix specs: params replicated, state leaves sharded on the
            # leading swarm axis, per-step outputs on axis 1 (steps lead).
            # check_vma=False: pallas_call does not annotate varying mesh
            # axes, and the body is per-shard independent by construction.
            seg_body = shard_map(seg_body, mesh=self.mesh,
                                 in_specs=(P(), P(SWARM_AXIS),
                                           P(None, SWARM_AXIS)),
                                 out_specs=(P(SWARM_AXIS),
                                            P(None, SWARM_AXIS)),
                                 check_vma=False)
        self._run_jit = jax.jit(seg_body)

    # -- checkpoint/resume ---------------------------------------------------

    def reset(self) -> None:
        """Rewind every swarm to its initial state (see GsoJaxRunner.reset)."""
        self._start_step = 0
        self.states = self._initial_states

    def resume_latest(self) -> int:
        """Resume the farm from snapshots (full-precision sidecars).

        The scan advances all swarms in lockstep, so the resume step is the
        *minimum over swarms of each swarm's newest sidecar step*: swarms
        that were further ahead are re-run from that step, which reproduces
        their trajectories bit-identically (the engine is deterministic and
        the RNG stream is positional), overwriting equal snapshots.  Swarms
        with missing or unreadable sidecars are reported loudly; if any
        swarm has none at all the farm restarts from step 0 with a WARNING
        (never silently).  Returns the resumed step (0 if none).
        """
        import logging

        from ..utils.output import read_state_sidecar

        log = logging.getLogger(__name__)
        root = pathlib.Path(self.output_root)
        newest = {}
        for sid in self.swarm_ids:
            steps = set()
            for p in (root / f"swarm_{sid}").glob("gso_*.out.npz"):
                m = re.match(r"gso_(\d+)\.out\.npz", p.name)
                if m:
                    steps.add(int(m.group(1)))
            newest[sid] = max(steps) if steps else 0
        if not any(newest.values()):
            if any((root / f"swarm_{sid}").exists() for sid in self.swarm_ids):
                log.warning(
                    "resume requested but no state sidecars found under %s: "
                    "restarting all %d swarms from step 0", root,
                    self.n_swarms)
            return 0
        step = min(newest.values())
        behind = [sid for sid, n in newest.items() if n > step]
        if step == 0:
            log.warning(
                "resume: swarm(s) %s have no sidecars; restarting ALL "
                "swarms from step 0 (others had snapshots up to step %d)",
                [sid for sid, n in newest.items() if n == 0],
                max(newest.values()))
            return 0
        if behind:
            log.warning(
                "resume: lockstep farm resumes at step %d (the minimum of "
                "the newest per-swarm snapshots); swarm(s) %s were ahead "
                "and will be re-run deterministically", step, behind)
        per_swarm = []
        for sid in self.swarm_ids:
            _, arrays = read_state_sidecar(
                root / f"swarm_{sid}" / f"gso_{step}.out")
            per_swarm.append(SwarmState(**{
                k: jnp.asarray(arrays[k]) for k in SwarmState._fields}))
        pad = len(self._padded) - self.n_swarms
        per_swarm += [per_swarm[0]] * pad
        self.states = shard_swarm_states(
            self.mesh,
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_swarm))
        self._start_step = step
        return step

    # -- execution -------------------------------------------------------

    def run_segmented(self, steps: int, segment: int = 10, metrics=None):
        g = self._padded[0].shape[0]
        s_pad = len(self._padded)
        if self._start_step >= steps:
            return self.states, None
        randoms_all = jax.device_put(
            jnp.asarray(swarm_randoms(self.seed, steps, s_pad, g,
                                      start_step=self._start_step),
                        dtype=self.dtype),
            self._randoms_sharding)
        base = self._start_step
        outs = None
        while self._start_step < steps:
            start = self._start_step
            target = min(start + segment, steps)
            rnd = jax.lax.slice_in_dim(randoms_all, start - base,
                                       target - base)
            t0 = time.time()
            self.states, outs = self._run_jit(self.params, self.states, rnd)
            if self.output_root is not None:
                write_swarm_outputs(outs, self.swarm_ids, self.use_anm,
                                    target, self.output_root,
                                    start_step=start, swarm_axis=1,
                                    sidecars=True)
            self._start_step = target
            if metrics is not None:
                np.asarray(jax.tree_util.tree_leaves(self.states)[0])
                metrics.segment(start, target,
                                (target - start) * g * self.n_swarms,
                                time.time() - t0)
        return self.states, outs


def run_swarm_farm(params, positions_list: Sequence[np.ndarray],
                   swarm_ids: List[int], seed: int, steps: int,
                   use_anm: bool, anm_rec: int, anm_lig: int,
                   dtype, output_root=".", energy_chunk: int = 0,
                   energy_mode: str = "xla",
                   n_atom_shards: int = 1, segment: int = 10,
                   metrics=None, resume: bool = False,
                   devices: Optional[Sequence] = None) -> None:
    """Run S swarms to completion and write their outputs (CLI entry).

    ``n_atom_shards > 1`` additionally shards receptor atoms over the
    mesh's atoms axis (2-D mesh path, XLA energy with psum/pmax
    collectives; ``energy_mode`` applies to the 1-D farm only).
    """
    if n_atom_shards > 1:
        from .sharded import run_multi_swarm_2d

        devices = list(devices if devices is not None else jax.devices())
        n_swarm_axis = max(1, min(len(positions_list),
                                  len(devices) // n_atom_shards))
        mesh = make_mesh(n_swarm=n_swarm_axis, n_atoms=n_atom_shards,
                         devices=devices)
        s = len(positions_list)
        pad = (-s) % n_swarm_axis
        padded = list(positions_list) + [positions_list[0]] * pad
        states = stack_swarm_states(padded, use_anm, anm_rec, anm_lig, dtype)
        randoms = swarm_randoms(seed, steps, len(padded),
                                padded[0].shape[0])
        _, outs = run_multi_swarm_2d(mesh, params, states, randoms)
        write_swarm_outputs(outs, swarm_ids, use_anm, steps, output_root,
                            swarm_axis=1, sidecars=True)
        return

    runner = SwarmFarmRunner(params, positions_list, swarm_ids, seed,
                             use_anm, anm_rec, anm_lig, dtype=dtype,
                             output_root=output_root,
                             energy_mode=energy_mode,
                             energy_chunk=energy_chunk, devices=devices)
    if resume:
        resumed = runner.resume_latest()
        if resumed:
            import logging
            logging.getLogger(__name__).info(
                "resumed %d swarms at step %d", runner.n_swarms, resumed)
    runner.run_segmented(steps, segment=segment, metrics=metrics)
