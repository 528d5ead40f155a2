"""Batched pose energies, generic over NumPy / jax.numpy.

The batched inversion of the reference's per-glowworm scoring loop: all
G poses of a swarm are scored in one shot over (G, Nr, Nl) tiles.  The
same source serves as:

* the NumPy batch path of the host parity engine (chunked over G), and
* the traced body of the jitted device engine (``xp=jax.numpy``), where it
  is written with only jit-compatible constructs (no boolean indexing, no
  data-dependent shapes).

Semantics mirror reference src/dfire.rs:264-362 and src/dna.rs:410-529.
Restraint/membrane bias uses a dense one-hot residue encoding so the
"any atom of the residue in the interface" reduction is a small matmul
(reference src/scoring.rs:21-47 semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import constants as C
from ..ops import quaternion as qt
from ..scoring import potentials, tables
from ..scoring.models import DockingModel


@dataclasses.dataclass
class BatchScoringParams:
    """Device-ready arrays for one receptor/ligand pair + method.

    Everything is a plain array (pytree-compatible); building happens once
    on the host.  ``dtype`` selects the device compute precision; the host
    oracle always uses float64.
    """

    method: str
    use_anm: bool
    # Receptor
    rec_coords: np.ndarray          # (Nr, 3)
    rec_nmodes: np.ndarray          # (Ka_r, Nr, 3)
    rec_res_onehot: np.ndarray      # (Rr, Nr) 0/1 — active restraint residues
    rec_membrane_mask: np.ndarray   # (Nr,) 0/1
    rec_num_membrane: int
    # Ligand
    lig_coords: np.ndarray          # (Nl, 3)
    lig_nmodes: np.ndarray          # (Ka_l, Nl, 3)
    lig_res_onehot: np.ndarray      # (Rl, Nl)
    # DFIRE
    atom_types_rec: Optional[np.ndarray] = None  # (Nr,) i32
    atom_types_lig: Optional[np.ndarray] = None  # (Nl,) i32
    potential: Optional[np.ndarray] = None       # (571220,)
    dist_to_bins: Optional[np.ndarray] = None    # (51,) i32
    # DNA / PYDOCK
    ele_rec: Optional[np.ndarray] = None
    ele_lig: Optional[np.ndarray] = None
    vdw_c_rec: Optional[np.ndarray] = None
    vdw_c_lig: Optional[np.ndarray] = None
    vdw_r_rec: Optional[np.ndarray] = None
    vdw_r_lig: Optional[np.ndarray] = None


def _res_onehot(model: DockingModel) -> np.ndarray:
    res_of_atom, n_res = model.restraint_segments()
    onehot = np.zeros((n_res, model.num_atoms), dtype=np.float64)
    hit = res_of_atom >= 0
    onehot[res_of_atom[hit], np.nonzero(hit)[0]] = 1.0
    return onehot


def build_batch_params(receptor: DockingModel, ligand: DockingModel,
                       use_anm: bool, dtype=np.float64,
                       potential: Optional[np.ndarray] = None
                       ) -> BatchScoringParams:
    """Build device-ready scoring params."""
    method = receptor.method
    mem_mask = np.zeros(receptor.num_atoms, dtype=dtype)
    mem_mask[receptor.membrane] = 1.0
    p = BatchScoringParams(
        method=method,
        use_anm=use_anm,
        rec_coords=receptor.coordinates.astype(dtype),
        rec_nmodes=receptor.nmodes.astype(dtype),
        rec_res_onehot=_res_onehot(receptor).astype(dtype),
        rec_membrane_mask=mem_mask,
        rec_num_membrane=int(receptor.membrane.size),
        lig_coords=ligand.coordinates.astype(dtype),
        lig_nmodes=ligand.nmodes.astype(dtype),
        lig_res_onehot=_res_onehot(ligand).astype(dtype),
    )
    if method == "dfire":
        p.atom_types_rec = receptor.atom_types.astype(np.int32)
        p.atom_types_lig = ligand.atom_types.astype(np.int32)
        pot = potential if potential is not None else potentials.load_potential()
        # Kept at f64 host-side; device upload downcasts to the run dtype
        # (gso_jax.device_params).
        p.potential = pot.astype(np.float64)
        p.dist_to_bins = tables.dfire_tables()["dist_to_bins"].astype(np.int32)
    else:
        p.ele_rec = receptor.ele_charges.astype(dtype)
        p.ele_lig = ligand.ele_charges.astype(dtype)
        p.vdw_c_rec = receptor.vdw_charges.astype(dtype)
        p.vdw_c_lig = ligand.vdw_charges.astype(dtype)
        p.vdw_r_rec = receptor.vdw_radii.astype(dtype)
        p.vdw_r_lig = ligand.vdw_radii.astype(dtype)
    return p


def batch_pose_coords(p: BatchScoringParams, t, q, a_rec, a_lig, xp=np):
    """Transformed coordinates for G poses.

    Returns (rec (G, Nr, 3), lig (G, Nl, 3)).  Ligand: quaternion rotation
    (as a (3,3) matrix contraction) + translation + ANM; receptor: ANM
    only.  Matches reference src/dfire.rs:274-320.
    """
    rot = qt.rotation_matrix(q, xp)                       # (G, 3, 3)
    # precision='highest' on every pose-transform contraction: at default
    # precision an f32 matmul may run in TF32 (about three decimal digits)
    # on the GPU, which would move coordinates by ~1e-3 A and DFIRE pairs
    # across bin edges.
    kw = {} if xp is np else {"precision": "highest"}
    lig = xp.einsum("gab,nb->gna", rot, p.lig_coords, **kw)  # (G, Nl, 3)
    lig = lig + t[:, None, :]
    if p.use_anm and p.lig_nmodes.shape[0] > 0:
        lig = lig + xp.einsum("gk,knc->gnc", a_lig, p.lig_nmodes, **kw)
    rec = xp.broadcast_to(p.rec_coords[None], (t.shape[0],) + p.rec_coords.shape)
    if p.use_anm and p.rec_nmodes.shape[0] > 0:
        rec = p.rec_coords[None] + xp.einsum("gk,knc->gnc", a_rec,
                                             p.rec_nmodes, **kw)
    return rec, lig


def _pair_d2(rec, lig, xp=np):
    diff = rec[:, :, None, :] - lig[:, None, :, :]
    return (diff * diff).sum(axis=-1)                     # (G, Nr, Nl)


def _bias(p: BatchScoringParams, score, iface_rec, iface_lig, xp=np):
    """score*(1 + frac_rec + frac_lig) - membrane penalty, batched."""
    def frac(onehot, iface):
        if onehot.shape[0] == 0:
            return xp.zeros(score.shape, dtype=score.dtype)
        hits = xp.einsum("rn,gn->gr", onehot, iface)       # atoms-in-iface per res
        return (hits > 0).astype(score.dtype).mean(axis=1)

    fr = frac(p.rec_res_onehot, iface_rec)
    fl = frac(p.lig_res_onehot, iface_lig)
    if p.rec_num_membrane > 0:
        inter = xp.einsum("n,gn->g", p.rec_membrane_mask, iface_rec) / p.rec_num_membrane
        penalty = C.MEMBRANE_PENALTY_SCORE * inter
    else:
        penalty = xp.zeros(score.shape, dtype=score.dtype)
    return score + fr * score + fl * score - penalty


def batch_energy(p: BatchScoringParams, t, q, a_rec, a_lig, xp=np):
    """Energies for G poses: returns (G,) scores.

    jit-compatible; all reductions are where-masked sums, no boolean
    indexing.
    """
    rec, lig = batch_pose_coords(p, t, q, a_rec, a_lig, xp)
    d2 = _pair_d2(rec, lig, xp)
    if p.method == "dfire":
        return _dfire_batch(p, d2, xp)
    return _elec_vdw_batch(p, d2, xp)


def batch_energy_parts(p: BatchScoringParams, t, q, a_rec, a_lig, xp=np):
    """Partial reductions for receptor-atom-axis sharding.

    With the receptor arrays of ``p`` holding only a shard of the atoms,
    returns per-pose partials that an ``axis_name`` psum/pmax combines:
    (raw (G,), iface_rec_local (G, Nr_local), iface_lig_partial (G, Nl)).
    ``raw`` is the pre-affine pair sum; apply ``finalize_raw`` after the
    cross-shard psum, then the bias (see parallel.sharded).
    """
    rec, lig = batch_pose_coords(p, t, q, a_rec, a_lig, xp)
    d2 = _pair_d2(rec, lig, xp)
    if p.method == "dfire":
        return _dfire_parts(p, d2, xp)
    return _elec_vdw_parts(p, d2, xp)


def finalize_raw(p: BatchScoringParams, raw):
    """Affine finish of the (possibly cross-shard-summed) raw pair sum."""
    if p.method == "dfire":
        return (raw * C.DFIRE_SCALE - C.DFIRE_OFFSET) * -1.0
    return raw * -1.0


def _dfire_parts(p: BatchScoringParams, d2, xp=np):
    """DFIRE pair sum: the reference's bin rule and one gather per pair
    from the flat table (reference src/dfire.rs:336-338)."""
    dtype = d2.dtype
    mask = d2 <= C.DFIRE_DIST_CUTOFF2
    d = xp.sqrt(xp.where(mask, d2, xp.ones_like(d2))) * 2.0 - 1.0
    slot = xp.clip(xp.trunc(d), 0, p.dist_to_bins.shape[0] - 1).astype(np.int32)
    bins = p.dist_to_bins[slot] - 1                        # (G, Nr, Nl)
    idx = (p.atom_types_rec[None, :, None].astype(np.int32)
           * np.int32(C.DFIRE_NUM_ATOM_TYPES * C.DFIRE_NUM_BINS)
           + p.atom_types_lig[None, None, :].astype(np.int32) * np.int32(C.DFIRE_NUM_BINS)
           + bins)
    contrib = p.potential[idx]
    raw = xp.where(mask, contrib, xp.zeros_like(contrib)).sum(axis=(1, 2))
    close = mask & (d <= C.INTERFACE_CUTOFF)
    iface_rec = close.any(axis=2).astype(dtype)
    iface_lig = close.any(axis=1).astype(dtype)
    return raw, iface_rec, iface_lig


def _dfire_batch(p: BatchScoringParams, d2, xp=np):
    raw, iface_rec, iface_lig = _dfire_parts(p, d2, xp)
    return _bias(p, finalize_raw(p, raw), iface_rec, iface_lig, xp)


def _elec_vdw_parts(p: BatchScoringParams, d2, xp=np):
    dtype = d2.dtype

    # d2 == 0 (coincident atoms) follows the reference exactly: division
    # by zero yields +-inf, which the clamps then pin to the elec cutoffs
    # (reference src/dna.rs:481-504); the vdw inf - inf becomes NaN and
    # survives the one-sided min, poisoning the pose's score like the
    # reference's unguarded float math does.  Measure-zero in practice,
    # but the device path must agree with the host oracle bit-for-bit on
    # the branch taken.
    import contextlib
    guard = (np.errstate(divide="ignore", invalid="ignore", over="ignore")
             if xp is np else contextlib.nullcontext())
    with guard:
        elec_mask = d2 <= C.ELEC_DIST_CUTOFF2
        elec = (p.ele_rec[None, :, None] * p.ele_lig[None, None, :]) / d2
        elec = xp.clip(elec, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF)
        total_elec = xp.where(elec_mask, elec, xp.zeros_like(elec)).sum(axis=(1, 2))

        vdw_mask = d2 <= C.VDW_DIST_CUTOFF2
        vdw_energy = xp.sqrt(p.vdw_c_rec[None, :, None] * p.vdw_c_lig[None, None, :])
        vdw_radius = p.vdw_r_rec[None, :, None] + p.vdw_r_lig[None, None, :]
        r2 = vdw_radius * vdw_radius
        p2 = r2 / d2
        p6 = p2 * p2 * p2
        k = xp.minimum(vdw_energy * (p6 * p6 - 2.0 * p6), C.VDW_CUTOFF)
        total_vdw = xp.where(vdw_mask, k, xp.zeros_like(k)).sum(axis=(1, 2))

    raw = total_elec * (C.FACTOR / C.EPSILON) + total_vdw

    close = d2 <= C.INTERFACE_CUTOFF2
    iface_rec = close.any(axis=2).astype(dtype)
    iface_lig = close.any(axis=1).astype(dtype)
    return raw, iface_rec, iface_lig


def _elec_vdw_batch(p: BatchScoringParams, d2, xp=np):
    raw, iface_rec, iface_lig = _elec_vdw_parts(p, d2, xp)
    return _bias(p, finalize_raw(p, raw), iface_rec, iface_lig, xp)
