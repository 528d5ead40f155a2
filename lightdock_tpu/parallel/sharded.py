"""Sharded execution: multi-swarm data parallelism + receptor-atom-axis
model parallelism with explicit collectives.

Levels (composable on a 2-D ``(swarm, atoms)`` mesh):

1. ``run_multi_swarm`` — S independent swarms batched on a leading axis and
   sharded over the mesh's ``swarm`` axis (pure data parallel; zero
   cross-device traffic during optimization — exactly the algorithm's
   communication structure, swarm interactions are intra-swarm only,
   reference src/swarm.rs:86-102).

2. ``atom_sharded_energy`` — the pairwise-energy "big dimension" sharded
   over the ``atoms`` axis: each device scores its slice of receptor atoms
   against the full ligand, then partial pair-sums are ``psum``-ed, ligand
   interface flags ``pmax``-ed (an OR), and restraint/membrane statistics
   psum-reduced before the bias — the context-parallel analogue for the
   (Nr x Nl) interaction matrix (SURVEY §5).

3. ``run_multi_swarm_2d`` — both at once under one ``shard_map``: swarms
   over the ``swarm`` axis, receptor atoms over the ``atoms`` axis; the
   movement phase is replicated across atom shards (cheap, deterministic).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as C
from ..engine.energy_batch import (BatchScoringParams, batch_energy_parts,
                                   finalize_raw)
from ..engine.gso_jax import SwarmState, gso_step, run_swarm
from .mesh import ATOM_AXIS, SWARM_AXIS, replicate_params, shard_swarm_states

# -- swarm-axis data parallelism -------------------------------------------


@functools.partial(jax.jit, static_argnames=("energy_chunk",))
def _scan_all_swarms(params, states, randoms, energy_chunk=0):
    # Module-level jit: repeat calls (farm segments, bench loops) reuse the
    # compiled executable instead of retracing a fresh closure every call.
    def run_one(state, rnd):
        return run_swarm(params, state, rnd, energy_chunk=energy_chunk)
    return jax.vmap(run_one, in_axes=(0, 1))(states, randoms)


def run_multi_swarm(mesh: Mesh, params: BatchScoringParams,
                    states: SwarmState, randoms, energy_chunk: int = 0):
    """Scan GSO for S swarms sharded over the mesh's swarm axis.

    ``states`` leaves have leading axis S; ``randoms`` is (steps, S, G).
    Returns (final states, stacked per-step outputs), swarm-sharded.
    """
    params = replicate_params(mesh, params)
    states = shard_swarm_states(mesh, states)
    randoms = jax.device_put(
        jnp.asarray(randoms), NamedSharding(mesh, P(None, SWARM_AXIS)))
    return _scan_all_swarms(params, states, randoms,
                            energy_chunk=energy_chunk)


# -- receptor-atom-axis sharding -------------------------------------------


def pad_params_for_atom_sharding(params: BatchScoringParams,
                                 n_shards: int) -> BatchScoringParams:
    """Pad the receptor-atom dimension to a multiple of ``n_shards``.

    Padding atoms are inert: coordinates at 1e6 fail every distance cutoff,
    so they contribute nothing to sums, interfaces or memberships.
    """
    nr = params.rec_coords.shape[0]
    pad = (-nr) % n_shards
    if pad == 0:
        return params

    def pad_axis(x, axis, value=0.0):
        if x is None:
            return None
        x = np.asarray(x)
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths, constant_values=value)

    return dataclasses.replace(
        params,
        rec_coords=pad_axis(params.rec_coords, 0, 1e6),
        rec_nmodes=pad_axis(params.rec_nmodes, 1),
        rec_res_onehot=pad_axis(params.rec_res_onehot, 1),
        rec_membrane_mask=pad_axis(params.rec_membrane_mask, 0),
        atom_types_rec=pad_axis(params.atom_types_rec, 0),
        ele_rec=pad_axis(params.ele_rec, 0),
        vdw_c_rec=pad_axis(params.vdw_c_rec, 0),
        vdw_r_rec=pad_axis(params.vdw_r_rec, 0, 1.0),
    )


# PartitionSpec for each params field when receptor atoms shard over the
# ``atoms`` axis (None field -> None spec so pytrees stay congruent).
_REC_ATOM_DIM = {
    "rec_coords": 0, "rec_nmodes": 1, "rec_res_onehot": 1,
    "rec_membrane_mask": 0, "atom_types_rec": 0,
    "ele_rec": 0, "vdw_c_rec": 0, "vdw_r_rec": 0,
}


def params_atom_specs(params: BatchScoringParams) -> BatchScoringParams:
    kwargs = {}
    for f in dataclasses.fields(BatchScoringParams):
        v = getattr(params, f.name)
        if f.name in ("method", "use_anm", "rec_num_membrane"):
            kwargs[f.name] = v
        elif v is None:
            kwargs[f.name] = None
        elif f.name in _REC_ATOM_DIM:
            dim = _REC_ATOM_DIM[f.name]
            spec = [None] * np.asarray(v).ndim
            spec[dim] = ATOM_AXIS
            kwargs[f.name] = P(*spec)
        else:
            kwargs[f.name] = P()
    return BatchScoringParams(**kwargs)


def atom_sharded_energy(p_local: BatchScoringParams, t, q, a_rec, a_lig,
                        axis_name: str = ATOM_AXIS,
                        moved=None, prev_scoring=None):
    """Pair energy with receptor atoms sharded over ``axis_name``.

    ``moved``/``prev_scoring`` (gso_step's rescoring gate) are accepted
    and ignored — dense recomputation is bit-identical for unmoved poses.

    Runs inside shard_map: ``p_local`` receptor arrays hold this device's
    shard.  Collectives: psum on the raw pair sum and per-residue hit
    counts, pmax (OR) on ligand interface flags, psum on membrane-bead
    intersections.
    """
    raw, iface_rec_loc, iface_lig_part = batch_energy_parts(
        p_local, t, q, a_rec, a_lig, xp=jnp)
    return _sharded_bias(p_local, raw, iface_rec_loc, iface_lig_part,
                         axis_name)


def _sharded_bias(p_local, raw, iface_rec_loc, iface_lig_part, axis_name):
    """Combine per-shard energy parts into final biased scores.

    Collectives: psum on the raw pair sum and per-residue hit counts,
    pmax (an OR) on ligand interface flags, psum on membrane-bead
    intersections."""
    raw = jax.lax.psum(raw, axis_name)
    score = finalize_raw(p_local, raw)
    iface_lig = jax.lax.pmax(iface_lig_part, axis_name)
    dtype = score.dtype

    # Receptor restraint fraction: residues may span shards; hit counts
    # combine additively before thresholding (semantics of reference
    # src/scoring.rs:21-36).
    if p_local.rec_res_onehot.shape[0] > 0:
        hits = jnp.einsum("rn,gn->gr", p_local.rec_res_onehot, iface_rec_loc)
        hits = jax.lax.psum(hits, axis_name)
        fr = (hits > 0).astype(dtype).mean(axis=1)
    else:
        fr = jnp.zeros_like(score)

    if p_local.lig_res_onehot.shape[0] > 0:
        lhits = jnp.einsum("rn,gn->gr", p_local.lig_res_onehot, iface_lig)
        fl = (lhits > 0).astype(dtype).mean(axis=1)
    else:
        fl = jnp.zeros_like(score)

    if p_local.rec_num_membrane > 0:
        inter = jnp.einsum("n,gn->g", p_local.rec_membrane_mask, iface_rec_loc)
        inter = jax.lax.psum(inter, axis_name) / p_local.rec_num_membrane
        penalty = C.MEMBRANE_PENALTY_SCORE * inter
    else:
        penalty = jnp.zeros_like(score)

    return score + fr * score + fl * score - penalty


def run_single_swarm_atom_sharded(mesh: Mesh, params: BatchScoringParams,
                                  state: SwarmState, randoms):
    """One swarm with the energy sharded over the mesh's atoms axis."""
    n_shards = mesh.shape[ATOM_AXIS]
    params = pad_params_for_atom_sharding(params, n_shards)
    specs = params_atom_specs(params)

    def body(p_loc, st, rnd):
        energy_fn = functools.partial(atom_sharded_energy, axis_name=ATOM_AXIS)

        def step(s, r):
            return gso_step(p_loc, s, r, energy_fn=energy_fn)

        return jax.lax.scan(step, st, rnd)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(specs, P(), P()),
                   out_specs=(P(), P()))
    return jax.jit(fn)(params, state, jnp.asarray(randoms, state.t.dtype))


def run_multi_swarm_2d(mesh: Mesh, params: BatchScoringParams,
                       states: SwarmState, randoms):
    """Full 2-D execution: swarms over SWARM_AXIS, receptor atoms over
    ATOM_AXIS, one shard_mapped scan.  ``randoms`` is (steps, S, G)."""
    n_shards = mesh.shape[ATOM_AXIS]
    params = pad_params_for_atom_sharding(params, n_shards)
    specs = params_atom_specs(params)
    from ..engine.gso_jax import StepOutput

    state_spec = jax.tree_util.tree_map(lambda _: P(SWARM_AXIS), states)
    out_state_spec = state_spec
    out_steps_spec = StepOutput(*([P(None, SWARM_AXIS)] * len(StepOutput._fields)))

    def body(p_loc, states_loc, randoms_loc):
        energy_fn = functools.partial(atom_sharded_energy, axis_name=ATOM_AXIS)

        def run_one(state, rnd):
            def step(s, r):
                return gso_step(p_loc, s, r, energy_fn=energy_fn)
            return jax.lax.scan(step, state, rnd)

        return jax.vmap(run_one, in_axes=(0, 1), out_axes=(0, 1))(
            states_loc, randoms_loc)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(specs, state_spec, P(None, SWARM_AXIS)),
                   out_specs=(out_state_spec, out_steps_spec))
    return jax.jit(fn)(params, states,
                       jnp.asarray(randoms, states.t.dtype))
