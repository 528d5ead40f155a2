"""Sharded execution on an 8-device (virtual CPU) mesh.

Atom-axis sharding (psum/pmax collectives), swarm-axis data parallelism,
and the combined 2-D mesh path must all reproduce the single-device
trajectory bit-for-bit (f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightdock_tpu.engine.energy_batch import build_batch_params
from lightdock_tpu.engine.gso_jax import device_params, init_state, run_swarm_jit
from lightdock_tpu.parallel import sharded
from lightdock_tpu.parallel.mesh import make_mesh
from lightdock_tpu.scoring.models import DockingModel
from lightdock_tpu.scoring.potentials import synthetic_potential
from lightdock_tpu.utils.rng import uniform_f64_stream

G, STEPS, NUM_ANM = 16, 4, 2


@pytest.fixture(scope="module")
def system():
    rng = np.random.RandomState(11)

    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-8, 8, size=(n, 3)),
            num_anm=NUM_ANM,
            nmodes=rng.standard_normal((NUM_ANM, n, 3)) * 0.1,
            membrane=np.array([1, 3], dtype=np.int64),
            active_restraints={"A.X.1": [0, 2], "A.X.2": [4]},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32))

    rec, lig = model(30), model(18)
    params = build_batch_params(rec, lig, use_anm=True,
                                potential=synthetic_potential())
    pos = np.concatenate([
        rng.uniform(-5, 5, (G, 3)), rng.standard_normal((G, 4)),
        rng.uniform(-1, 1, (G, NUM_ANM)), rng.uniform(-1, 1, (G, NUM_ANM))],
        axis=1)
    pos[:, 3:7] /= np.linalg.norm(pos[:, 3:7], axis=1, keepdims=True)
    state = init_state(pos, True, NUM_ANM, NUM_ANM, dtype=jnp.float64)
    randoms = jnp.asarray(uniform_f64_stream(1, STEPS * G).reshape(STEPS, G))
    base_final, _ = run_swarm_jit(device_params(params, np.float64),
                                  state, randoms)
    return params, state, randoms, base_final


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_atom_sharded_energy_matches(system):
    params, state, randoms, base = system
    mesh = make_mesh(n_swarm=1, n_atoms=8)
    final, _ = sharded.run_single_swarm_atom_sharded(mesh, params, state, randoms)
    np.testing.assert_allclose(np.asarray(final.scoring),
                               np.asarray(base.scoring), rtol=0, atol=1e-12)
    assert np.array_equal(np.asarray(final.num_neighbors),
                          np.asarray(base.num_neighbors))


def test_multi_swarm_dp_matches(system):
    params, state, randoms, base = system
    s = 4
    states = jax.tree_util.tree_map(lambda x: jnp.stack([x] * s), state)
    rnds = jnp.stack([randoms] * s, axis=1)
    mesh = make_mesh(n_swarm=4, n_atoms=2)
    final, _ = sharded.run_multi_swarm(mesh, device_params(params, np.float64),
                                       states, rnds)
    for i in range(s):
        np.testing.assert_array_equal(np.asarray(final.scoring)[i],
                                      np.asarray(base.scoring))


def test_2d_mesh_matches(system):
    params, state, randoms, base = system
    s = 4
    states = jax.tree_util.tree_map(lambda x: jnp.stack([x] * s), state)
    rnds = jnp.stack([randoms] * s, axis=1)
    mesh = make_mesh(n_swarm=4, n_atoms=2)
    final, outs = sharded.run_multi_swarm_2d(mesh, params, states, rnds)
    np.testing.assert_allclose(np.asarray(final.scoring),
                               np.broadcast_to(np.asarray(base.scoring), (s, G)),
                               rtol=0, atol=1e-12)
    assert np.asarray(outs.t).shape == (STEPS, s, G, 3)


def test_uneven_atom_padding(system):
    """30 receptor atoms over 8 shards needs padding to 32; padded atoms
    must be inert."""
    params, state, randoms, base = system
    padded = sharded.pad_params_for_atom_sharding(params, 8)
    assert padded.rec_coords.shape[0] == 32
    from lightdock_tpu.engine.energy_batch import batch_energy
    e_pad = batch_energy(device_params(padded, np.float64),
                         state.t, state.q, state.a_rec, state.a_lig, xp=jnp)
    e_ref = batch_energy(device_params(params, np.float64),
                         state.t, state.q, state.a_rec, state.a_lig, xp=jnp)
    np.testing.assert_allclose(np.asarray(e_pad), np.asarray(e_ref),
                               rtol=0, atol=1e-12)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out.scoring)).all()
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_multi_swarm_farm_golden_1azp(tmp_path):
    """The multi-swarm farm path must reproduce the 1azp golden when fed
    that single swarm (f64, CPU mesh)."""
    import os
    import pathlib
    reference = pathlib.Path(os.environ.get("LIGHTDOCK_REFERENCE",
                                            "/root/reference"))
    if not reference.exists():
        pytest.skip("reference data unavailable")
    ex = reference / "example/1azp"
    from lightdock_tpu.parallel.farm import run_swarm_farm
    from lightdock_tpu.simulation import load_simulation
    sim = load_simulation(ex / "setup.json", ex / "initial_positions_0.dat",
                          "dna", anm_dir=ex)
    run_swarm_farm(sim.batch_params(), [sim.positions, sim.positions],
                   [0, 1], sim.seed, 10, sim.use_anm, sim.setup.anm_rec,
                   sim.setup.anm_lig, jnp.float64, output_root=str(tmp_path),
                   energy_chunk=25)
    golden = (ex / "swarm_0/gso_10.out").read_text()
    assert (tmp_path / "swarm_0/gso_10.out").read_text() == golden
    assert (tmp_path / "swarm_1/gso_10.out").read_text() == golden
