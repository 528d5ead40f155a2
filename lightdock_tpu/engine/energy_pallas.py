"""Kernel energy path: drop-in ``energy_fn`` for the GSO engine built on
the DFIRE pair kernel (ops.pallas_energy).

Host side, once: spatially sort both atom axes so kernel tiles are
compact, and compute the static tile boxes of the cull.  Traced, per call:
pose transform in XLA -> cull mask in XLA -> pair kernel -> bias in XLA,
with the signature of engine.energy_batch.batch_energy plus the
moved-pose gate.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..ops import quaternion as qt
from ..ops.pallas_energy import (L_BLK, NUM_SLOTS, R_BLK, anm_mode_bounds,
                                 cull_mask_boxes, dfire_pairs, pose_slack,
                                 rcb_order, slot_table, tile_boxes)
from .energy_batch import BatchScoringParams, _bias, finalize_raw

# Receptor-atom fields permuted by spatial_sort_params, with their atom axis.
_REC_FIELDS = {"rec_coords": 0, "rec_nmodes": 1, "rec_res_onehot": 1,
               "rec_membrane_mask": 0, "atom_types_rec": 0, "ele_rec": 0,
               "vdw_c_rec": 0, "vdw_r_rec": 0}
_LIG_FIELDS = {"lig_coords": 0, "lig_nmodes": 1, "lig_res_onehot": 1,
               "atom_types_lig": 0, "ele_lig": 0, "vdw_c_lig": 0,
               "vdw_r_lig": 0}


def spatial_sort_params(params: BatchScoringParams, r_blk: int = R_BLK,
                        l_blk: int = L_BLK) -> BatchScoringParams:
    """Permute both atom axes into tile-aware recursive-bisection order.

    Semantically free (every per-atom array is permuted consistently, so
    energies and biases are unchanged) but tile bounding boxes become
    compact, which is what makes the cull effective.
    """
    pr = rcb_order(params.rec_coords, r_blk)
    pl_ = rcb_order(params.lig_coords, l_blk)
    kw = {}
    for fields, perm in ((_REC_FIELDS, pr), (_LIG_FIELDS, pl_)):
        for name, axis in fields.items():
            v = getattr(params, name)
            if v is not None:
                kw[name] = np.take(np.asarray(v), perm, axis=axis)
    return dataclasses.replace(params, **kw)


def make_pallas_energy_fn(params: BatchScoringParams, interpret: bool = False,
                          cull: bool = True, r_blk: int = R_BLK,
                          l_blk: int = L_BLK):
    """Build energy_fn(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None)
    -> (G,) scores for DFIRE ``params`` (spatially sorted by the caller
    for the cull to bite; any atom order gives the same energies).

    The closure captures only small host-side geometry (tile boxes, ANM
    mode bounds); the large arrays flow through the ``p`` pytree.  With
    ``moved``/``prev_scoring`` (the reference's moved||step==0 rescoring
    gate, src/glowworm.rs:61-72) unmoved poses skip the kernel and keep
    their stored score.
    """
    if params.method != "dfire":
        raise ValueError("the pair kernel covers DFIRE only; "
                         f"{params.method!r} runs on the XLA path")
    for blk in (r_blk, l_blk):
        if blk < 1 or blk & (blk - 1):
            raise ValueError(f"kernel block sizes must be a power of two, "
                             f"got {blk}")
    nr = params.rec_coords.shape[0]
    nl = params.lig_coords.shape[0]
    nr_pad = -(-nr // r_blk) * r_blk
    nl_pad = -(-nl // l_blk) * l_blk
    dtype = np.dtype(params.rec_coords.dtype)
    rc, rh = (jnp.asarray(a, dtype) for a in tile_boxes(params.rec_coords, r_blk))
    lc, lh = (jnp.asarray(a, dtype) for a in tile_boxes(params.lig_coords, l_blk))
    rec_bounds = (anm_mode_bounds(params.rec_nmodes) if params.use_anm
                  else np.zeros(0))
    lig_bounds = (anm_mode_bounds(params.lig_nmodes) if params.use_anm
                  else np.zeros(0))
    rec_anm = params.use_anm and params.rec_nmodes.shape[0] > 0
    # Interface flags feed only the restraint/membrane bias; without
    # either, the bias is the identity and the kernel skips them.
    need_iface = (params.rec_res_onehot.shape[0] > 0
                  or params.lig_res_onehot.shape[0] > 0
                  or params.rec_num_membrane > 0)

    def energy_fn(p: BatchScoringParams, t, q, a_rec, a_lig, moved=None,
                  prev_scoring=None):
        g = t.shape[0]
        rot = qt.rotation_matrix(q, jnp)                      # (G, 3, 3)
        # Pose transform at full f32 precision (a TF32 product would move
        # coordinates by ~1e-3 A).
        lig = jnp.einsum("gab,nb->gan", rot, p.lig_coords,
                         precision="highest") + t[:, :, None]
        if p.use_anm and p.lig_nmodes.shape[0] > 0:
            lig = lig + jnp.einsum("gk,knc->gcn", a_lig, p.lig_nmodes,
                                   precision="highest")
        rec = p.rec_coords.T[None]                            # (1, 3, Nr)
        if rec_anm:
            rec = rec + jnp.einsum("gk,knc->gcn", a_rec, p.rec_nmodes,
                                   precision="highest")
        rec = jnp.pad(rec, ((0, 0), (0, 0), (0, nr_pad - nr)))
        lig = jnp.pad(lig, ((0, 0), (0, 0), (0, nl_pad - nl)))
        rtypes = jnp.pad(p.atom_types_rec.astype(jnp.int32)
                         * (C.DFIRE_NUM_ATOM_TYPES * NUM_SLOTS),
                         (0, nr_pad - nr))
        ltypes = jnp.pad(p.atom_types_lig.astype(jnp.int32) * NUM_SLOTS,
                         (0, nl_pad - nl))
        table = slot_table(p.potential.astype(t.dtype), p.dist_to_bins)

        if cull:
            rs = pose_slack(a_rec, rec_bounds) if p.use_anm else jnp.zeros(g, t.dtype)
            ls = pose_slack(a_lig, lig_bounds) if p.use_anm else jnp.zeros(g, t.dtype)
            act = cull_mask_boxes(rc, rh, lc, lh, t, rot, rs, ls,
                                  np.sqrt(C.DFIRE_DIST_CUTOFF2))
        else:
            act = jnp.ones((g, nr_pad // r_blk, nl_pad // l_blk), jnp.int32)
        if moved is not None:
            act = act * moved.astype(jnp.int32)[:, None, None]

        raw, ifr, ifl = dfire_pairs(
            rec.astype(t.dtype), lig.astype(t.dtype), rtypes, ltypes,
            table, act, nr=nr, nl=nl, need_iface=need_iface,
            interpret=interpret, r_blk=r_blk, l_blk=l_blk)
        score = finalize_raw(p, raw)
        if need_iface:
            score = _bias(p, score, ifr[:, :nr].astype(t.dtype),
                          ifl[:, :nl].astype(t.dtype), jnp)
        if moved is not None and prev_scoring is not None:
            score = jnp.where(moved, score, prev_scoring)
        return score

    return energy_fn
