"""chip_smoke.py at tiny size on the CPU: every phase that does not need
the compiled kernel, the oracle tolerance, and the refusal to run off a
GPU or outside the repository."""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from lightdock_tpu import synthetic
from lightdock_tpu.synthetic import ComplexShape

TINY = cs.Sizes(
    glowworms=8, swarms=2, steps=10, steps_1k4c=10, oracle_poses=4,
    farm_swarms=8,
    shapes=(("1ppe", ComplexShape("1ppe", 160, 40, "dfire")),
            ("2uuy", ComplexShape("2uuy", 160, 60, "dfire", anm=True)),
            ("1azp", ComplexShape("1azp", 120, 64, "dna", anm=True)),
            ("1k4c", ComplexShape("1k4c", 200, 150, "dfire", membrane=20,
                                  restraints=3))))


@pytest.mark.parametrize("phase", ["a", "b", "c", "d"])
def test_phase_at_tiny_size(phase, tmp_path):
    res = getattr(cs, f"phase_{phase}")(tmp_path, TINY)
    assert res["run_s"] > 0 and res["poses_per_s"] > 0
    oracle = res["oracle"]
    assert oracle["max_abs_err"] <= oracle["max_tol"]
    if phase == "b":
        assert (tmp_path / "1ppe_farm" / "rank_by_scoring.list").exists()
        assert (tmp_path / "1ppe_farm" / "swarm_1" / "gso_10.out").exists()
    if phase == "d":
        assert res["energy_chunk"] == 0   # tiny complex: no chunking


def test_four_card_comparisons_on_virtual_devices(tmp_path):
    """The --four-cards phase on four of the eight virtual CPU devices:
    sharded farm == one-device farm, 2 x 2 atom-sharded mesh within
    tolerance with no selection flip."""
    import jax

    res = cs.four_cards(tmp_path, TINY, devices=jax.devices()[:4])
    assert all(res["farm"]["identical"].values())
    assert set(res["farm"]["per_card_swarms"].values()) == {2}
    assert res["atom_sharded"]["max_score_diff"] <= res["atom_sharded"]["tol"]
    assert res["atom_sharded"]["selection_flips"] == 0


def test_four_card_check_fails_without_psum(tmp_path, monkeypatch):
    """With the cross-shard psum replaced by a pmax, the pair sum keeps
    only one receptor half's partial: the 2 x 2 comparison must fail."""
    import jax

    monkeypatch.setattr(jax.lax, "psum",
                        lambda x, axis_name, **kw: jax.lax.pmax(x, axis_name))
    with pytest.raises(AssertionError):
        cs.four_card_atom_sharded(tmp_path, TINY, devices=jax.devices()[:4])


def test_bias_einsums_identical_at_default_and_highest(tmp_path):
    inputs = synthetic.make_complex(TINY.shape("1k4c"), tmp_path, swarms=1,
                                    glowworms=4)
    assert cs.check_bias_precision(synthetic.load(inputs), n_poses=8)


def test_oracle_tolerance_rejects_a_wrong_energy(tmp_path):
    """The derived tolerance is tight enough to catch a real error: one
    DFIRE pair term (scale 0.0157 x ~1) is far outside it."""
    inputs = synthetic.make_complex(TINY.shape("1ppe"), tmp_path, swarms=1,
                                    glowworms=4)
    sim = synthetic.load(inputs)
    from lightdock_tpu.utils.positions import split_positions

    t, q, ar, al = split_positions(sim.positions, False, 0, 0)
    b = cs.oracle_bounds(sim, t[0], q[0], ar[0], al[0])
    assert np.isfinite(b.e64) and 0 < b.tol < 1e-2
    assert b.n_near >= 0 and b.de_edges >= 0
    assert 0 < b.tol_paths <= 2 * b.tol


@pytest.fixture(scope="module")
def sim_1ppe(tmp_path_factory):
    """The 1ppe shape at its published width (1615 x 221 atoms)."""
    inputs = synthetic.make_complex("1ppe", tmp_path_factory.mktemp("1ppe"),
                                    swarms=1, glowworms=4)
    return synthetic.load(inputs)


def _tile_sums(srt, t, q, r_blk, l_blk):
    """f64 raw DFIRE sum of every (receptor tile, ligand tile) pair of the
    kernel's tiling, per pose: (G, nR, nL)."""
    from lightdock_tpu import constants as C
    from lightdock_tpu.ops import quaternion as qt
    from lightdock_tpu.ops.pallas_energy import NUM_SLOTS, slot_table

    table = slot_table(np.asarray(srt.potential, np.float64),
                       np.asarray(srt.dist_to_bins), xp=np).reshape(
        C.DFIRE_NUM_ATOM_TYPES, C.DFIRE_NUM_ATOM_TYPES, NUM_SLOTS)
    rec = np.asarray(srt.rec_coords, np.float64)
    nr, nl = rec.shape[0], srt.lig_coords.shape[0]
    pr, pl = (-nr) % r_blk, (-nl) % l_blk
    pair_t = table[srt.atom_types_rec[:, None], srt.atom_types_lig[None, :]]
    out = []
    for rot, tr in zip(qt.rotation_matrix(q, np), t):
        lig = np.asarray(srt.lig_coords, np.float64) @ rot.T + tr
        d2 = ((rec[:, None, :] - lig[None, :, :]) ** 2).sum(-1)
        slot = np.clip(np.trunc(np.sqrt(d2) * 2 - 1), 0, NUM_SLOTS - 1)
        terms = np.take_along_axis(pair_t, slot.astype(np.int64)[..., None],
                                   -1)[..., 0] * (d2 <= C.DFIRE_DIST_CUTOFF2)
        terms = np.pad(terms, ((0, pr), (0, pl)))
        out.append(terms.reshape((nr + pr) // r_blk, r_blk,
                                 (nl + pl) // l_blk, l_blk).sum(axis=(1, 3)))
    return np.stack(out)


def test_oracle_check_catches_a_dropped_tile(sim_1ppe, monkeypatch):
    """At the 1ppe width, a cull that wrongly skips one tile pair per pose
    (the one with the largest contribution) makes the kernel's energies
    fail the oracle check; the same kernel with the true cull passes."""
    import jax.numpy as jnp

    from lightdock_tpu.engine import energy_pallas as ep
    from lightdock_tpu.engine.gso_jax import device_params

    sim = sim_1ppe
    t, q, ar, al = cs._contact_poses(sim, 4)
    pose = [jnp.asarray(x, jnp.float32) for x in (t, q, ar, al)]
    srt = ep.spatial_sort_params(sim.batch_params(dtype=np.float32))
    sums = np.abs(_tile_sums(srt, t, q, ep.R_BLK, ep.L_BLK))
    keep = np.ones(sums.shape, np.int32)
    for g, flat in enumerate(sums.reshape(len(t), -1).argmax(axis=1)):
        keep[(g,) + np.unravel_index(flat, sums.shape[1:])] = 0
    bounds = [cs.oracle_bounds(sim, t[i], q[i], ar[i], al[i]) for i in range(4)]
    e64 = np.array([b.e64 for b in bounds])
    tol = np.array([b.tol for b in bounds])

    def energies():
        fn = ep.make_pallas_energy_fn(srt, interpret=True)
        return np.asarray(fn(device_params(srt, np.float32), *pose), np.float64)

    assert (np.abs(energies() - e64) <= tol).all()
    real_cull = ep.cull_mask_boxes
    monkeypatch.setattr(ep, "cull_mask_boxes",
                        lambda *a: real_cull(*a) * jnp.asarray(keep))
    assert (np.abs(energies() - e64) > tol).all()


def test_main_refuses_a_cpu_backend():
    with pytest.raises(SystemExit, match="GPU is required"):
        cs.main([])


def test_script_alone_fails_without_result(tmp_path):
    """Copied out of the repository, the script exits non-zero and prints
    no result line."""
    shutil.copy(pathlib.Path(cs.__file__), tmp_path / "chip_smoke.py")
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
