"""Device (JAX) engine parity with the host oracle engine."""

import jax.numpy as jnp
import numpy as np
import pytest

from lightdock_tpu.engine.energy_batch import build_batch_params
from lightdock_tpu.engine.gso_host import GsoHostEngine
from lightdock_tpu.engine.gso_jax import GsoJaxRunner, init_state
from lightdock_tpu.scoring.models import DockingModel
from lightdock_tpu.scoring.potentials import synthetic_potential
from lightdock_tpu.simulation import load_simulation
from lightdock_tpu.utils.rng import uniform_f64_stream


def _random_positions(rng, g, anm_rec=0, anm_lig=0):
    t = rng.uniform(-10, 10, size=(g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cols = [t, q]
    if anm_rec:
        cols.append(rng.uniform(-1, 1, size=(g, anm_rec)))
    if anm_lig:
        cols.append(rng.uniform(-1, 1, size=(g, anm_lig)))
    return np.concatenate(cols, axis=1)


def _toy_dfire_models(rng, n_rec=24, n_lig=18, num_anm=3):
    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=num_anm,
            nmodes=rng.standard_normal((num_anm, n, 3)) * 0.1,
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32),
        )
    return model(n_rec), model(n_lig)


def test_jax_engine_matches_host_toy_dfire():
    """20 GSO steps on a toy DFIRE system (ANM on): device engine must
    track the host oracle step-for-step."""
    rng = np.random.RandomState(11)
    rec, lig = _toy_dfire_models(rng)
    pot = synthetic_potential()
    params = build_batch_params(rec, lig, use_anm=True, potential=pot)
    positions = _random_positions(rng, g=32, anm_rec=3, anm_lig=3)

    host = GsoHostEngine(params, positions, seed=324324, use_anm=True,
                         anm_rec=3, anm_lig=3)
    host.run(20)

    runner = GsoJaxRunner(params, positions, seed=324324, use_anm=True,
                          anm_rec=3, anm_lig=3, dtype=jnp.float64)
    final, _ = runner.run(20)

    assert np.array_equal(np.asarray(final.num_neighbors), host.num_neighbors)
    np.testing.assert_allclose(np.asarray(final.t), host.t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(final.q), host.q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(final.luciferin), host.luciferin,
                               rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(np.asarray(final.vision), host.vision,
                               rtol=0, atol=1e-12)


@pytest.mark.slow
def test_jax_engine_matches_host_1azp(reference_dir):
    ex = reference_dir / "example/1azp"
    sim = load_simulation(ex / "setup.json", ex / "initial_positions_0.dat",
                          "dna", anm_dir=ex)
    host = GsoHostEngine(sim.batch_params(), sim.positions, sim.seed,
                         sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig)
    host.run(3)
    runner = GsoJaxRunner(sim.batch_params(), sim.positions, sim.seed,
                          sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                          dtype=jnp.float64, energy_chunk=25)
    final, _ = runner.run(3)
    assert np.array_equal(np.asarray(final.num_neighbors), host.num_neighbors)
    np.testing.assert_allclose(np.asarray(final.t), host.t, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(final.scoring), host.scoring,
                               rtol=1e-9, atol=1e-8)


def test_energy_chunking_invariance():
    """Chunked energy evaluation must not change results."""
    rng = np.random.RandomState(2)
    rec, lig = _toy_dfire_models(rng, num_anm=0)
    params = build_batch_params(rec, lig, use_anm=False,
                                potential=synthetic_potential())
    positions = _random_positions(rng, g=30)
    for chunk in (0, 7, 30):
        runner = GsoJaxRunner(params, positions, seed=1, use_anm=False,
                              anm_rec=0, anm_lig=0, dtype=jnp.float64,
                              energy_chunk=chunk)
        final, _ = runner.run(5)
        if chunk == 0:
            base = np.asarray(final.scoring)
        else:
            np.testing.assert_allclose(np.asarray(final.scoring), base,
                                       rtol=1e-12, atol=1e-12)


def test_f32_engine_is_close():
    """The f32 device path follows the f64 trajectory for early steps
    on a toy system."""
    rng = np.random.RandomState(4)
    rec, lig = _toy_dfire_models(rng, num_anm=0)
    params = build_batch_params(rec, lig, use_anm=False,
                                potential=synthetic_potential())
    positions = _random_positions(rng, g=16)
    r64 = GsoJaxRunner(params, positions, seed=7, use_anm=False,
                       anm_rec=0, anm_lig=0, dtype=jnp.float64)
    f64, _ = r64.run(3)
    r32 = GsoJaxRunner(params, positions, seed=7, use_anm=False,
                       anm_rec=0, anm_lig=0, dtype=jnp.float32)
    f32, _ = r32.run(3)
    np.testing.assert_allclose(np.asarray(f32.t), np.asarray(f64.t),
                               rtol=1e-3, atol=1e-3)


def test_mixed_precision_energy():
    """energy_dtype (the mixed tier, docs/precision.md): f64 state +
    f32 scoring tracks the all-f64 run closely for early steps, and the
    wrapper is a no-op when dtypes agree."""
    from lightdock_tpu.engine.gso_jax import mixed_precision_energy

    def efn(p, t, q, ar, al, moved=None, prev_scoring=None):
        return t.sum(axis=1)

    assert mixed_precision_energy(efn, jnp.float32, None) is efn
    assert mixed_precision_energy(efn, jnp.float32, jnp.float32) is efn

    rng = np.random.RandomState(5)
    rec, lig = _toy_dfire_models(rng, num_anm=0)
    params = build_batch_params(rec, lig, use_anm=False,
                                potential=synthetic_potential())
    positions = _random_positions(rng, g=16)
    r64 = GsoJaxRunner(params, positions, seed=7, use_anm=False,
                       anm_rec=0, anm_lig=0, dtype=jnp.float64)
    f64, _ = r64.run(3)
    rmix = GsoJaxRunner(params, positions, seed=7, use_anm=False,
                        anm_rec=0, anm_lig=0, dtype=jnp.float64,
                        energy_dtype=jnp.float32)
    fmix, _ = rmix.run(3)
    assert np.asarray(fmix.t).dtype == np.float64
    np.testing.assert_allclose(np.asarray(fmix.t), np.asarray(f64.t),
                               rtol=1e-3, atol=1e-3)
    # The other direction: f32 state + f64 scoring.
    rmix2 = GsoJaxRunner(params, positions, seed=7, use_anm=False,
                         anm_rec=0, anm_lig=0, dtype=jnp.float32,
                         energy_dtype=jnp.float64)
    fmix2, _ = rmix2.run(3)
    assert np.asarray(fmix2.t).dtype == np.float32
    np.testing.assert_allclose(np.asarray(fmix2.t), np.asarray(f64.t),
                               rtol=1e-3, atol=1e-3)


def test_run_segmented_matches_monolithic(tmp_path):
    """Segmented execution (async device-side chaining) must produce the
    identical trajectory and identical snapshot files."""
    rng = np.random.RandomState(8)
    rec, lig = _toy_dfire_models(rng, num_anm=2)
    params = build_batch_params(rec, lig, use_anm=True,
                                potential=synthetic_potential())
    positions = _random_positions(rng, g=16, anm_rec=2, anm_lig=2)

    mono_dir = tmp_path / "mono"
    mono = GsoJaxRunner(params, positions, seed=11, use_anm=True, anm_rec=2,
                        anm_lig=2, output_directory=str(mono_dir),
                        dtype=jnp.float64)
    mono_final, _ = mono.run(20)

    seg_dir = tmp_path / "seg"
    seg = GsoJaxRunner(params, positions, seed=11, use_anm=True, anm_rec=2,
                       anm_lig=2, output_directory=str(seg_dir),
                       dtype=jnp.float64)
    seg_final, _ = seg.run_segmented(20, 7)  # deliberately misaligned

    np.testing.assert_array_equal(np.asarray(seg_final.t),
                                  np.asarray(mono_final.t))
    np.testing.assert_array_equal(np.asarray(seg_final.scoring),
                                  np.asarray(mono_final.scoring))
    for step in (1, 10, 20):
        a = (mono_dir / f"gso_{step}.out").read_text()
        b = (seg_dir / f"gso_{step}.out").read_text()
        assert a == b, f"snapshot {step} differs"


def test_pick_energy_mode_auto():
    """auto resolves to XLA on a CPU backend, whatever the complex size."""
    import dataclasses
    from lightdock_tpu.engine.gso_jax import pick_energy_mode
    rng = np.random.RandomState(0)
    rec, lig = _toy_dfire_models(rng)
    params = build_batch_params(rec, lig, use_anm=False,
                                potential=synthetic_potential())
    assert pick_energy_mode(params) == "xla"  # small + CPU backend
    big = dataclasses.replace(
        params,
        rec_coords=np.zeros((4000, 3), np.float32),
        lig_coords=np.zeros((4000, 3), np.float32))
    # still xla because the test backend is CPU
    assert pick_energy_mode(big) == "xla"


def test_pick_energy_mode_auto_gpu(monkeypatch):
    """On a GPU backend, auto picks the DFIRE kernel at every complex size
    and keeps the elec/vdw methods on XLA."""
    import dataclasses
    import lightdock_tpu.engine.gso_jax as gj
    monkeypatch.setattr(gj.jax, "default_backend", lambda: "gpu")
    rng = np.random.RandomState(0)
    rec, lig = _toy_dfire_models(rng)
    params = build_batch_params(rec, lig, use_anm=False,
                                potential=synthetic_potential())
    assert gj.pick_energy_mode(params) == "pallas"  # small complex

    def sized(p, nr, nl, **kw):
        return dataclasses.replace(p, rec_coords=np.zeros((nr, 3)),
                                   lig_coords=np.zeros((nl, 3)), **kw)

    assert gj.pick_energy_mode(sized(params, 640, 32)) == "pallas"
    assert gj.pick_energy_mode(sized(params, 3413, 3268)) == "pallas"
    assert gj.pick_energy_mode(sized(params, 1094, 506, method="dna")) == "xla"
    assert gj.pick_energy_mode(sized(params, 1094, 506, method="pydock")) == "xla"
