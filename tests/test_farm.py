"""Production multi-swarm farm (parallel.farm): flat-batched energy over
all swarms must reproduce per-swarm single runs exactly, the DFIRE kernel
energy mode must match the XLA mode, and resume must be bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightdock_tpu.engine.energy_batch import build_batch_params
from lightdock_tpu.engine.gso_jax import GsoJaxRunner
from lightdock_tpu.parallel.farm import SwarmFarmRunner
from lightdock_tpu.scoring.models import DockingModel
from lightdock_tpu.scoring.potentials import synthetic_potential

G, NUM_ANM = 16, 2


def _system(method="dfire", n_rec=40, n_lig=25, seed=7, n_swarms=3):
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
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=NUM_ANM,
            nmodes=rng.standard_normal((NUM_ANM, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={}, passive_restraints={}, **kw)

    params = build_batch_params(
        model(n_rec), model(n_lig), use_anm=True,
        potential=synthetic_potential() if method == "dfire" else None)

    def positions():
        pos = np.concatenate([
            rng.uniform(-5, 5, (G, 3)), rng.standard_normal((G, 4)),
            rng.uniform(-1, 1, (G, NUM_ANM)), rng.uniform(-1, 1, (G, NUM_ANM))],
            axis=1)
        pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
        return pos

    return params, [positions() for _ in range(n_swarms)]


def test_farm_matches_single_swarm_runs(tmp_path):
    """Each swarm in the farm (distinct initial positions, shard_map over
    3 virtual devices) must write byte-identical snapshots to a standalone
    single-swarm run of the same positions."""
    params, positions_list = _system()
    farm = SwarmFarmRunner(params, positions_list, [0, 1, 2], seed=324324,
                           use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM,
                           dtype=jnp.float64, output_root=str(tmp_path / "farm"),
                           energy_mode="xla")
    assert farm.mesh.devices.size == 3  # shard_map path exercised
    farm.run_segmented(20, segment=10)

    for i, pos in enumerate(positions_list):
        single = GsoJaxRunner(params, pos, seed=324324, use_anm=True,
                              anm_rec=NUM_ANM, anm_lig=NUM_ANM,
                              output_directory=str(tmp_path / f"single_{i}"),
                              dtype=jnp.float64)
        single.run(20)
        for step in (1, 10, 20):
            a = (tmp_path / "farm" / f"swarm_{i}" / f"gso_{step}.out").read_text()
            b = (tmp_path / f"single_{i}" / f"gso_{step}.out").read_text()
            assert a == b, f"swarm {i} step {step}"


@pytest.mark.parametrize("method", ["dfire"])
def test_farm_pallas_matches_xla(method, tmp_path):
    """energy_mode='pallas' (the DFIRE kernel, interpret mode on CPU) must
    reproduce the XLA farm trajectory: same selections, f64-close state."""
    params, positions_list = _system(method=method, n_swarms=2)
    runs = {}
    for mode in ("xla", "pallas"):
        farm = SwarmFarmRunner(params, positions_list, [0, 1], seed=324324,
                               use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM,
                               dtype=jnp.float64, output_root=None,
                               energy_mode=mode, interpret=mode == "pallas")
        farm.run_segmented(10, segment=10)
        runs[mode] = farm.states
    np.testing.assert_allclose(np.asarray(runs["pallas"].t),
                               np.asarray(runs["xla"].t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(runs["pallas"].scoring),
                               np.asarray(runs["xla"].scoring),
                               rtol=1e-9, atol=1e-9)
    assert np.array_equal(np.asarray(runs["pallas"].num_neighbors),
                          np.asarray(runs["xla"].num_neighbors))


def test_farm_resume_bit_exact(tmp_path):
    """Interrupt after 10 steps, resume in a fresh runner: snapshots at 20
    must be byte-identical to the uninterrupted farm."""
    params, positions_list = _system(n_swarms=2)
    kw = dict(seed=324324, use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM,
              dtype=jnp.float64, energy_mode="xla")

    full = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "full"), **kw)
    full.run_segmented(20, segment=10)

    part = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "part"), **kw)
    part.run_segmented(10, segment=10)

    cont = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "part"), **kw)
    assert cont.resume_latest() == 10
    cont.run_segmented(20, segment=10)

    for i in (0, 1):
        a = (tmp_path / "full" / f"swarm_{i}" / "gso_20.out").read_text()
        b = (tmp_path / "part" / f"swarm_{i}" / "gso_20.out").read_text()
        assert a == b


def test_farm_resume_survives_missing_sidecar(tmp_path, caplog):
    """A deleted/corrupted sidecar in one swarm no longer silently restarts
    the farm: it resumes from that swarm's newest remaining step (the
    lockstep minimum), warns about the swarms that were ahead, and the
    final snapshots still match the uninterrupted run bit-for-bit."""
    import logging

    params, positions_list = _system(n_swarms=2)
    kw = dict(seed=324324, use_anm=True, anm_rec=NUM_ANM, anm_lig=NUM_ANM,
              dtype=jnp.float64, energy_mode="xla")

    full = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "full"), **kw)
    full.run_segmented(20, segment=10)

    part = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "part"), **kw)
    part.run_segmented(20, segment=10)
    # swarm 1 loses its newest sidecar: only step 10 remains there.
    (tmp_path / "part" / "swarm_1" / "gso_20.out.npz").unlink()

    cont = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "part"), **kw)
    with caplog.at_level(logging.WARNING, "lightdock_tpu.parallel.farm"):
        assert cont.resume_latest() == 10
    assert any("were ahead" in r.message for r in caplog.records)
    cont.run_segmented(20, segment=10)
    for i in (0, 1):
        a = (tmp_path / "full" / f"swarm_{i}" / "gso_20.out").read_text()
        b = (tmp_path / "part" / f"swarm_{i}" / "gso_20.out").read_text()
        assert a == b

    # A swarm with NO sidecars at all => restart from 0, loudly.
    for p in (tmp_path / "part" / "swarm_0").glob("*.npz"):
        p.unlink()
    cold = SwarmFarmRunner(params, positions_list, [0, 1],
                           output_root=str(tmp_path / "part"), **kw)
    with caplog.at_level(logging.WARNING, "lightdock_tpu.parallel.farm"):
        assert cold.resume_latest() == 0
    assert any("restarting ALL" in r.message for r in caplog.records)


def test_farm_pads_swarms_to_device_multiple(tmp_path):
    """5 swarms over 8 virtual devices: mesh uses 5 devices; 9 swarms pad
    to 16 shards without writing phantom swarm dirs."""
    params, positions_list = _system(n_swarms=5)
    farm = SwarmFarmRunner(params, positions_list, [0, 1, 2, 3, 9],
                           seed=1, use_anm=True, anm_rec=NUM_ANM,
                           anm_lig=NUM_ANM, dtype=jnp.float64,
                           output_root=str(tmp_path), energy_mode="xla")
    assert farm.mesh.devices.size == 5
    farm.run_segmented(10, segment=10)
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert dirs == ["swarm_0", "swarm_1", "swarm_2", "swarm_3", "swarm_9"]


def test_farm_tile_validation():
    """The kernel path validates its inputs up front: DFIRE only, and only
    on a GPU unless interpret mode is asked for."""
    params, positions_list = _system(method="dna", n_swarms=1)
    with pytest.raises(ValueError, match="DFIRE only"):
        SwarmFarmRunner(params, positions_list, [0], seed=1, use_anm=True,
                        anm_rec=NUM_ANM, anm_lig=NUM_ANM,
                        energy_mode="pallas", interpret=True)
    params, positions_list = _system(n_swarms=1)
    runner = GsoJaxRunner(params, positions_list[0], seed=1, use_anm=True,
                          anm_rec=NUM_ANM, anm_lig=NUM_ANM,
                          energy_mode="pallas")
    with pytest.raises(RuntimeError, match="NVIDIA GPUs only"):
        runner.run(1)
    with pytest.raises(ValueError, match="energy_mode"):
        GsoJaxRunner(params, positions_list[0], seed=1, use_anm=True,
                     anm_rec=NUM_ANM, anm_lig=NUM_ANM, energy_mode="pallas_v1")
