"""DFIRE pair-energy kernel for NVIDIA GPUs (Pallas through Triton), plus
the host-side tile geometry its spatial cull is built from.

Design:

* Grid over (pose, receptor tile).  Blocks run in parallel, in no order;
  each one loops over the ligand tiles itself, so nothing carries over
  between blocks.
* Culling: a (pose, receptor tile, ligand tile) mask computed by XLA from
  static tile bounding boxes (``cull_mask_boxes``) marks the tile pairs
  that may hold an atom pair within the 15 A cutoff; the block skips the
  others.  The moved-pose gate is folded into the same mask.
* Per pair: d2 in f32 by direct differences on the CUDA cores (never a
  dot, which may run in TF32 and move d2 across a bin edge), the
  reference's bin rule ``trunc(2 sqrt(d2) - 1)`` (reference
  src/dfire.rs:336-338), and ONE gather from the slot-indexed potential
  table (``slot_table``: the flat DFIRE table with the distance-to-bin map
  folded in, 3.4 MB, L2-resident).
* Reductions: each block writes its partial pose sum and the interface
  flags of the receptor tile it owns; ligand flags are written per
  receptor tile and OR-reduced by XLA.  No atomics, so results repeat run
  to run.

The pose transform and the restraint/membrane bias stay in XLA
(engine.energy_pallas).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import constants as C

# Block sizes (powers of two, as Triton requires), chosen on the card by a
# sweep of 32 to 128 atoms a side at the 1ppe and 1k4c shapes (PERF.md).
# NUM_WARPS and NUM_STAGES were not tuned.
R_BLK = 32
L_BLK = 32
NUM_WARPS = 4
NUM_STAGES = 1

# Distance slots trunc(2 sqrt(d2) - 1) reachable inside the 15 A cutoff:
# d2 <= 225 -> slot <= 29.
NUM_SLOTS = 30
_TYPES = C.DFIRE_NUM_ATOM_TYPES


def slot_table(potential, dist_to_bins, xp=jnp):
    """Flat (169 * 169 * NUM_SLOTS,) table T[ta, tb, slot] =
    potential[(ta * 169 + tb) * 20 + dist_to_bins[slot] - 1]: the
    reference's two lookups (slot -> bin -> flat table) folded into one
    gather.  The flat index keeps the reference's arithmetic, so a bin of
    20 reads the next type pair's first entry as the reference does
    (clamped at the table's end, like the XLA gather)."""
    bins = dist_to_bins[:NUM_SLOTS] - 1
    base = xp.arange(_TYPES * _TYPES)[:, None] * C.DFIRE_NUM_BINS
    idx = xp.minimum(base + bins[None, :], potential.shape[0] - 1)
    return potential[idx].reshape(-1)


def _dfire_kernel(act_ref, rec_ref, rtype_ref, lig_ref, ltype_ref, table_ref,
                  raw_ref, *iface_refs, nr, nl, r_blk, l_blk, n_l,
                  rec_per_pose, need_iface):
    g = pl.program_id(0)
    r = pl.program_id(1)
    rg = g if rec_per_pose else 0
    rows = pl.ds(r * r_blk, r_blk)
    rx = rec_ref[rg, 0, rows]
    ry = rec_ref[rg, 1, rows]
    rz = rec_ref[rg, 2, rows]
    rt = rtype_ref[rows]
    r_ok = (r * r_blk + jnp.arange(r_blk)) < nr

    def tile(l, carry):
        acc, ifr = carry
        cols = pl.ds(l * l_blk, l_blk)

        def compute():
            dx = rx[:, None] - lig_ref[g, 0, cols][None, :]
            dy = ry[:, None] - lig_ref[g, 1, cols][None, :]
            dz = rz[:, None] - lig_ref[g, 2, cols][None, :]
            d2 = dx * dx + dy * dy + dz * dz
            l_ok = (l * l_blk + jnp.arange(l_blk)) < nl
            inside = (d2 <= C.DFIRE_DIST_CUTOFF2) & r_ok[:, None] & l_ok[None, :]
            d = jnp.sqrt(d2) * 2.0 - 1.0
            # float -> int conversion truncates toward zero, like the
            # reference's `d as usize` for d > -1.
            slot = jnp.clip(d.astype(jnp.int32), 0, NUM_SLOTS - 1)
            idx = rt[:, None] + ltype_ref[cols][None, :] + slot
            e = plgpu.load(table_ref.at[idx], mask=inside, other=0.0)
            if not need_iface:
                return acc + e, ifr
            close = (inside & (d <= C.INTERFACE_CUTOFF)).astype(jnp.int32)
            iface_refs[1][g, r, cols] = jnp.max(close, axis=0).astype(jnp.int8)
            return acc + e, jnp.maximum(ifr, jnp.max(close, axis=1))

        def skip():
            if need_iface:
                iface_refs[1][g, r, cols] = jnp.zeros((l_blk,), jnp.int8)
            return acc, ifr

        return jax.lax.cond(act_ref[g, r, l] != 0, compute, skip)

    acc0 = jnp.zeros((r_blk, l_blk), table_ref.dtype)
    ifr0 = jnp.zeros((r_blk,), jnp.int32)
    acc, ifr = jax.lax.fori_loop(0, n_l, tile, (acc0, ifr0))
    raw_ref[g, r] = jnp.sum(acc)
    if need_iface:
        iface_refs[0][g, rows] = ifr.astype(jnp.int8)


def dfire_pairs(rec, lig, rec_types, lig_types, table, active, *, nr: int,
                nl: int, need_iface: bool, interpret: bool = False,
                r_blk: int = R_BLK, l_blk: int = L_BLK):
    """Raw DFIRE pair sums and interface flags for G poses.

    rec: (1 or G, 3, Nr_pad) receptor coordinates (one shared copy when
    the receptor is rigid); lig: (G, 3, Nl_pad); rec_types/lig_types:
    (Nr_pad,)/(Nl_pad,) int32 offsets into ``table`` (type * 169 * 30 and
    type * 30); table: ``slot_table``; active: (G, n_r, n_l) int32 cull
    mask.  ``nr``/``nl`` are the real atom counts (padding never counts).
    Coordinates, table and sums share one dtype (f32 in production).

    Returns raw (G,), iface_rec (G, Nr_pad) and iface_lig (G, Nl_pad) as
    int8 0/1 flags (None when ``need_iface`` is False).

    The kernel compiles for NVIDIA GPUs only.  ``interpret=True`` runs it
    in the Pallas interpreter (tests on the CPU); without it, any other
    backend is an error rather than a silent fallback.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the DFIRE pair kernel compiles for NVIDIA GPUs only; pass "
            f"interpret=True to run it on the {jax.default_backend()!r} "
            "backend")
    g = lig.shape[0]
    nr_pad, nl_pad = rec.shape[2], lig.shape[2]
    assert nr_pad % r_blk == 0 and nl_pad % l_blk == 0, (nr_pad, nl_pad)
    n_r, n_l = nr_pad // r_blk, nl_pad // l_blk
    assert active.shape == (g, n_r, n_l), (active.shape, (g, n_r, n_l))
    out_shape = [jax.ShapeDtypeStruct((g, n_r), table.dtype)]
    if need_iface:
        out_shape += [jax.ShapeDtypeStruct((g, nr_pad), jnp.int8),
                      jax.ShapeDtypeStruct((g, n_r, nl_pad), jnp.int8)]
    kernel = functools.partial(
        _dfire_kernel, nr=nr, nl=nl, r_blk=r_blk, l_blk=l_blk, n_l=n_l,
        rec_per_pose=rec.shape[0] > 1, need_iface=need_iface)
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(g, n_r),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="dfire_pairs",
    )(active, rec, rec_types, lig, lig_types, table)
    raw = outs[0].sum(axis=1)
    if not need_iface:
        return raw, None, None
    return raw, outs[1], outs[2].max(axis=1)


# --------------------------------------------------------------------------
# Conservative tile culling (host geometry + traced mask)
# --------------------------------------------------------------------------


def rcb_order(coords: np.ndarray, tile: int) -> np.ndarray:
    """Recursive-coordinate-bisection atom permutation, tile-aware.

    Splits the atom set along its widest axis at a multiple-of-``tile``
    boundary nearest the median, recursing until each contiguous chunk
    holds at most ``tile`` atoms, so every kernel tile is a compact spatial
    cluster by construction.  Returns the permutation indices (N,).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    out = np.empty(n, dtype=np.int64)
    pos = 0

    def rec(idx):
        nonlocal pos
        m = idx.size
        if m <= tile:
            out[pos:pos + m] = idx
            pos += m
            return
        c = coords[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        cut = ((-(-m // tile)) // 2) * tile
        rec(order[:cut])
        rec(order[cut:])

    rec(np.arange(n))
    return out


def tile_boxes(coords: np.ndarray, tile: int):
    """Static per-tile axis-aligned bounding boxes: (centers (nT, 3),
    half_extents (nT, 3)).  All-padding tiles get half-extent -inf, so a
    box test can never activate them."""
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    pad = (-n) % tile
    real = np.ones(n + pad, dtype=bool)
    real[n:] = False
    c = np.pad(coords, ((0, pad), (0, 0)))
    c_t = c.reshape(-1, tile, 3)
    real_t = real.reshape(-1, tile)[..., None]
    lo = np.where(real_t, c_t, np.inf).min(axis=1)
    hi = np.where(real_t, c_t, -np.inf).max(axis=1)
    empty = ~np.isfinite(lo).all(axis=1)
    centers = np.where(empty[:, None], 0.0, (lo + hi) / 2.0)
    half = np.where(empty[:, None], -np.inf, (hi - lo) / 2.0)
    return centers, half


def anm_mode_bounds(nmodes: np.ndarray) -> np.ndarray:
    """Per-mode maximum atom displacement norm (K,) for the slack bound."""
    nmodes = np.asarray(nmodes, dtype=np.float64)
    if nmodes.shape[0] == 0:
        return np.zeros(0)
    return np.linalg.norm(nmodes, axis=-1).max(axis=1)


def pose_slack(coefs, mode_bounds):
    """Per-pose upper bound on any atom's ANM displacement: (G,)."""
    if mode_bounds.shape[0] == 0:
        return jnp.zeros(coefs.shape[0], dtype=coefs.dtype)
    return jnp.abs(coefs) @ jnp.asarray(mode_bounds, dtype=coefs.dtype)


# Added to every cutoff: covers the f32 rounding of the traced box test
# (coordinates of ~100 A carry ~1e-5 A of rounding), so the cull stays
# conservative.
CULL_MARGIN = 0.01


def cull_mask_boxes(rec_centers, rec_half, lig_centers_base, lig_half,
                    t, rot, rec_slack, lig_slack, cutoff):
    """(G, nR, nL) int32 mask: 1 where a tile pair may hold an atom pair
    within ``cutoff`` for pose g.

    The receptor tile is a static AABB; the ligand tile's rotated box is
    re-projected onto the world axes (half-extent |R_g| h, the tight AABB
    of an oriented box), so the per-axis gap

        gap_c = max(0, |c_rec - (R_g c_lig + t_g)|_c - (h_rec + |R_g| h_lig
                    + slack)_c)

    lower-bounds every atom-pair distance component; skipping when
    sum(gap^2) > cutoff^2 is exact.  ANM slack (a bound on displacement
    norm) widens each axis.  The contractions run at full f32 precision:
    a TF32 product would make the bound inexact.  Padding tiles (-inf
    half-extents) are masked out explicitly.
    """
    valid_r = jnp.isfinite(rec_half).all(-1)                      # (nR,)
    valid_l = jnp.isfinite(lig_half).all(-1)                      # (nL,)
    rec_half = jnp.where(valid_r[:, None], rec_half, 0.0)
    lig_half = jnp.where(valid_l[:, None], lig_half, 0.0)
    lc = jnp.einsum("gab,nb->gna", rot, lig_centers_base,
                    precision="highest") + t[:, None, :]
    lh = jnp.einsum("gab,nb->gna", jnp.abs(rot), lig_half,
                    precision="highest")                          # (G, nL, 3)
    slack = (rec_slack + lig_slack)[:, None, None, None]
    diff = jnp.abs(rec_centers[None, :, None, :] - lc[:, None, :, :])
    reach = rec_half[None, :, None, :] + lh[:, None, :, :] + slack
    gap = jnp.maximum(diff - reach, 0.0)                          # (G, nR, nL, 3)
    d2_lb = (gap * gap).sum(-1)
    ok = valid_r[None, :, None] & valid_l[None, None, :]
    return (ok & (d2_lb <= (float(cutoff) + CULL_MARGIN) ** 2)).astype(jnp.int32)
