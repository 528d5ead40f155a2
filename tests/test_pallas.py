"""DFIRE pair kernel (ops.pallas_energy) in interpret mode vs the XLA path,
plus the host tile geometry of its cull.

The compiled kernel runs only on an NVIDIA GPU (tests/test_gpu.py); here
the Pallas interpreter validates indexing, padding, culling and the
moved-pose gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightdock_tpu import constants as C
from lightdock_tpu.engine.energy_batch import batch_energy, build_batch_params
from lightdock_tpu.engine.energy_pallas import (make_pallas_energy_fn,
                                                spatial_sort_params)
from lightdock_tpu.engine.gso_jax import device_params
from lightdock_tpu.ops import pallas_energy as pe
from lightdock_tpu.scoring.models import DockingModel
from lightdock_tpu.scoring.potentials import synthetic_potential

BLK = dict(r_blk=32, l_blk=32)


def _system(n_rec=150, n_lig=90, num_anm=2, seed=3, spread=20, bias=True,
            dtype=np.float32, g=11, method="dfire"):
    rng = np.random.RandomState(seed)

    def model(n):
        kw = {}
        if method == "dfire":
            kw["atom_types"] = rng.randint(0, 168, size=n).astype(np.int32)
        else:
            kw.update(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0, 0.5, n),
                      vdw_radii=rng.uniform(0.5, 2.5, n))
        return DockingModel(
            method=method,
            coordinates=rng.uniform(-spread, spread, size=(n, 3)),
            num_anm=num_anm,
            nmodes=rng.standard_normal((num_anm, n, 3)) * 0.2,
            membrane=np.array([0, 5] if bias else [], dtype=np.int64),
            active_restraints={"A.1": [1, 2], "A.2": [7]} if bias else {},
            passive_restraints={}, **kw)

    params = build_batch_params(
        model(n_rec), model(n_lig), use_anm=num_anm > 0, dtype=dtype,
        potential=synthetic_potential() if method == "dfire" else None)
    t = rng.uniform(-1.2 * spread, 1.2 * spread, (g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a_r = rng.uniform(-1, 1, (g, num_anm))
    a_l = rng.uniform(-1, 1, (g, num_anm))
    return params, [jnp.asarray(x, dtype) for x in (t, q, a_r, a_l)]


def _kernel(params, pose, dtype=np.float32, **kw):
    sp = spatial_sort_params(params, BLK["r_blk"], BLK["l_blk"])
    fn = make_pallas_energy_fn(sp, interpret=True, **BLK, **kw)
    return np.asarray(fn(device_params(sp, dtype), *pose))


def _xla(params, pose, dtype=np.float32):
    return np.asarray(batch_energy(device_params(params, dtype), *pose, xp=jnp))


@pytest.mark.quick
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("num_anm", [0, 2])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_xla_gather(dtype, num_anm, bias):
    """Same bin rule, same table values: f64 agrees to rounding, f32 to
    accumulation order."""
    params, pose = _system(num_anm=num_anm, bias=bias, dtype=dtype)
    ref = _xla(params, pose, dtype)
    out = _kernel(params, pose, dtype)
    tol = 1e-12 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("num_anm", [0, 2])
def test_culling_is_conservative(num_anm):
    """Culled and unculled runs agree exactly: every culled tile pair has
    provably zero contribution."""
    params, pose = _system(num_anm=num_anm)
    np.testing.assert_array_equal(_kernel(params, pose, cull=True),
                                  _kernel(params, pose, cull=False))


def test_cull_mask_covers_every_pair_in_cutoff():
    """Brute force: every (pose, tile pair) holding an atom pair within
    15 A is active in the box mask."""
    from lightdock_tpu.ops import quaternion as qt

    params, pose = _system(num_anm=0, g=7)
    sp = spatial_sort_params(params, 32, 32)
    t, q = (np.asarray(x, np.float64) for x in pose[:2])
    rc, rh = pe.tile_boxes(sp.rec_coords, 32)
    lc, lh = pe.tile_boxes(sp.lig_coords, 32)
    rot = qt.rotation_matrix(jnp.asarray(q), jnp)
    act = np.asarray(pe.cull_mask_boxes(
        jnp.asarray(rc), jnp.asarray(rh), jnp.asarray(lc), jnp.asarray(lh),
        jnp.asarray(t), rot, jnp.zeros(7), jnp.zeros(7), 15.0))
    lig = np.einsum("gab,nb->gna", np.asarray(rot), sp.lig_coords) + t[:, None]
    d2 = ((sp.rec_coords[None, :, None] - lig[:, None]) ** 2).sum(-1)
    nr, nl = sp.rec_coords.shape[0], sp.lig_coords.shape[0]
    pad_r, pad_l = (-nr) % 32, (-nl) % 32
    hit = np.pad(d2 <= C.DFIRE_DIST_CUTOFF2, ((0, 0), (0, pad_r), (0, pad_l)))
    need = hit.reshape(7, -1, 32, hit.shape[2] // 32, 32).any(axis=(2, 4))
    assert not (need & (act == 0)).any()
    assert act.shape == need.shape


def test_culling_actually_culls():
    """Sorted atoms and distant poses: most tile pairs are skipped."""
    from lightdock_tpu.ops import quaternion as qt

    params, pose = _system(spread=60)
    sp = spatial_sort_params(params, 32, 32)
    t, q = pose[0] * 2.0, pose[1]
    rc, rh = pe.tile_boxes(sp.rec_coords, 32)
    lc, lh = pe.tile_boxes(sp.lig_coords, 32)
    act = pe.cull_mask_boxes(
        jnp.asarray(rc, jnp.float32), jnp.asarray(rh, jnp.float32),
        jnp.asarray(lc, jnp.float32), jnp.asarray(lh, jnp.float32),
        t, qt.rotation_matrix(q, jnp), jnp.zeros(t.shape[0]),
        jnp.zeros(t.shape[0]), 15.0)
    assert float(np.asarray(act).mean()) < 0.7


def test_spatial_sort_preserves_energies():
    params, pose = _system()
    ref = _xla(params, pose)
    out = _xla(spatial_sort_params(params), pose)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("r_blk,l_blk", [(16, 32), (32, 16), (64, 64)])
def test_block_sizes_and_padding(r_blk, l_blk):
    """Atom counts that are not block multiples pad inertly at any block
    shape (150 x 90 atoms)."""
    params, pose = _system(num_anm=2)
    ref = _xla(params, pose)
    sp = spatial_sort_params(params, r_blk, l_blk)
    out = make_pallas_energy_fn(sp, interpret=True, r_blk=r_blk,
                                l_blk=l_blk)(device_params(sp, np.float32), *pose)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("g", [1, 3, 11])
def test_odd_pose_counts(g):
    params, pose = _system(num_anm=0, g=g)
    out = _kernel(params, pose)
    assert out.shape == (g,)
    np.testing.assert_allclose(out, _xla(params, pose), rtol=2e-5, atol=2e-5)


def test_moved_skip():
    """Unmoved poses return their stored score exactly; moved poses match
    the ungated computation."""
    params, pose = _system(num_anm=0)
    sp = spatial_sort_params(params, 32, 32)
    fn = make_pallas_energy_fn(sp, interpret=True, **BLK)
    dp = device_params(sp, np.float32)
    full = np.asarray(fn(dp, *pose))
    g = full.shape[0]
    rng = np.random.RandomState(11)
    moved = jnp.asarray(rng.rand(g) < 0.6)
    prev = jnp.asarray(rng.uniform(-5, 5, g).astype(np.float32))
    gated = np.asarray(fn(dp, *pose, moved=moved, prev_scoring=prev))
    m = np.asarray(moved)
    np.testing.assert_array_equal(gated[~m], np.asarray(prev)[~m])
    np.testing.assert_array_equal(gated[m], full[m])


def test_slot_table_matches_reference_lookup():
    """T[ta, tb, slot] is the reference's flat-table value for that slot's
    bin, including the spill of bin 20 into the next type pair."""
    from lightdock_tpu.scoring import tables

    pot = synthetic_potential()
    d2b = tables.dfire_tables()["dist_to_bins"]
    t = pe.slot_table(pot, np.asarray(d2b), xp=np).reshape(169, 169, pe.NUM_SLOTS)
    rng = np.random.RandomState(0)
    for ta, tb, s in zip(rng.randint(0, 169, 50), rng.randint(0, 169, 50),
                         rng.randint(0, pe.NUM_SLOTS, 50)):
        idx = min(ta * 3380 + tb * 20 + d2b[s] - 1, pot.size - 1)
        assert t[ta, tb, s] == pot[idx]
    np.testing.assert_array_equal(
        np.asarray(pe.slot_table(jnp.asarray(pot), jnp.asarray(d2b))),
        t.reshape(-1))


def test_kernel_without_interpret_raises_off_gpu():
    """No silent interpreter fallback: off the GPU the compiled kernel is
    an error unless the caller asks for interpret mode."""
    assert jax.default_backend() != "gpu"
    params, pose = _system(num_anm=0)
    sp = spatial_sort_params(params)
    with pytest.raises(RuntimeError, match="NVIDIA GPUs only"):
        make_pallas_energy_fn(sp)(device_params(sp, np.float32), *pose)


def test_kernel_covers_dfire_only():
    params, _ = _system(method="dna")
    with pytest.raises(ValueError, match="DFIRE only"):
        make_pallas_energy_fn(params, interpret=True)


def test_block_sizes_must_be_powers_of_two():
    params, _ = _system()
    with pytest.raises(ValueError, match="power of two"):
        make_pallas_energy_fn(params, interpret=True, r_blk=48)


def test_rcb_order_is_permutation_and_compact():
    rng = np.random.RandomState(7)
    coords = rng.uniform(-50, 50, (1000, 3))
    perm = pe.rcb_order(coords, 64)
    assert sorted(perm) == list(range(1000))
    vol = lambda h: np.prod(2 * h, axis=1).mean()  # noqa: E731
    assert vol(pe.tile_boxes(coords[perm], 64)[1]) < vol(pe.tile_boxes(coords, 64)[1])


def test_tile_boxes_padding():
    """200 atoms in 128-atom tiles: two boxes, each holding its atoms (the
    second tile is part padding, which never widens the box)."""
    coords = np.random.RandomState(0).uniform(-5, 5, (200, 3))
    centers, half = pe.tile_boxes(coords, 128)
    assert centers.shape == (2, 3) and half.shape == (2, 3)
    assert np.isfinite(half).all()
    for i, chunk in enumerate((coords[:128], coords[128:])):
        assert (np.abs(chunk - centers[i]) <= half[i] + 1e-12).all()
        np.testing.assert_allclose(half[i], np.ptp(chunk, axis=0) / 2)


def test_anm_slack_bound():
    rng = np.random.RandomState(2)
    nmodes = rng.standard_normal((4, 50, 3))
    bounds = pe.anm_mode_bounds(nmodes)
    coefs = rng.uniform(-2, 2, (9, 4))
    slack = np.asarray(pe.pose_slack(jnp.asarray(coefs), bounds))
    disp = np.einsum("gk,kna->gna", coefs, nmodes)
    actual = np.linalg.norm(disp, axis=-1).max(axis=1)
    assert (slack + 1e-9 >= actual).all()
