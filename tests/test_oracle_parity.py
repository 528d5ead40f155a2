"""Device batch energies against the f64 host oracle (engine.energy_host).

Every device energy form (the XLA path, and the DFIRE pair kernel in
interpret mode), with and without ANM, with each bias, at f32 and f64, on seeded synthetic systems that need no external data.  The
f64 device path must agree to rounding; the f32 path must stay inside the
tolerance chip_smoke.oracle_bounds derives (summation rounding plus the
worst effect of every pair within the f32 band of a bin edge or cutoff).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import oracle_bounds
from lightdock_tpu.engine.energy_batch import batch_energy, build_batch_params
from lightdock_tpu.engine.energy_pallas import (make_pallas_energy_fn,
                                                spatial_sort_params)
from lightdock_tpu.engine.energy_host import HostScorer
from lightdock_tpu.engine.gso_jax import device_params
from lightdock_tpu.scoring.models import DockingModel
from lightdock_tpu.scoring.potentials import synthetic_potential
from lightdock_tpu.synthetic import globule

N_REC, N_LIG, G, K = 90, 40, 5, 3


def _sim(method, anm, bias, seed=5):
    rng = np.random.RandomState(seed)
    scoring = "dfire" if method.startswith("dfire") else method

    def model(coords, membrane=()):
        n = coords.shape[0]
        kw = {}
        if scoring == "dfire":
            kw["atom_types"] = rng.randint(0, 168, n).astype(np.int32)
        else:
            kw.update(ele_charges=rng.uniform(-1, 1, n),
                      vdw_charges=rng.uniform(0.05, 0.5, n),
                      vdw_radii=rng.uniform(1.0, 2.0, n))
        restraints = ({f"A.R.{i}": list(range(3 * i, 3 * i + 3))
                       for i in range(4)} if bias == "restraints" else {})
        return DockingModel(
            method=scoring, coordinates=coords, num_anm=K if anm else 0,
            nmodes=(rng.standard_normal((K, n, 3)) * 0.05 if anm
                    else np.zeros((0, n, 3))),
            membrane=np.asarray(membrane, dtype=np.int64),
            active_restraints=restraints, passive_restraints={}, **kw)

    rec = model(globule(N_REC, rng),
                membrane=range(N_REC - 8, N_REC) if bias == "membrane" else ())
    lig = model(globule(N_LIG, rng))
    pot = synthetic_potential() if scoring == "dfire" else None
    host = HostScorer(scoring, rec, lig, anm, potential=pot)
    sim = types.SimpleNamespace(receptor=rec, ligand=lig, method=scoring,
                                use_anm=anm, host_scorer=lambda: host)
    # Poses in contact: ligand centres 8-14 A from the receptor centre.
    d = rng.standard_normal((G, 3))
    t = d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(8, 14, (G, 1))
    q = rng.standard_normal((G, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ar = rng.uniform(-1, 1, (G, K if anm else 0))
    al = rng.uniform(-1, 1, (G, K if anm else 0))
    return sim, pot, (t, q, ar, al)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bias", ["none", "restraints", "membrane"])
@pytest.mark.parametrize("anm", [False, True])
@pytest.mark.parametrize("method", ["dfire-kernel", "dfire-gather", "dna",
                                    "pydock"])
def test_batch_energy_matches_f64_oracle(method, anm, bias, dtype):
    sim, pot, (t, q, ar, al) = _sim(method, anm, bias)
    params = build_batch_params(sim.receptor, sim.ligand, anm, dtype=dtype,
                                potential=pot)
    pose = [jnp.asarray(x, dtype) for x in (t, q, ar, al)]
    if method == "dfire-kernel":
        params = spatial_sort_params(params, 32, 32)
        fn = make_pallas_energy_fn(params, interpret=True, r_blk=32, l_blk=32)
        dev = fn(device_params(params, dtype), *pose)
    else:
        dev = batch_energy(device_params(params, dtype), *pose, xp=jnp)
    dev = np.asarray(dev, np.float64)
    rows = [oracle_bounds(sim, t[i], q[i], ar[i], al[i]) for i in range(G)]
    e64 = np.array([r.e64 for r in rows])
    assert np.isfinite(e64).all()
    if bias == "none" and sim.method == "dfire":
        # contact poses: the pair sum is not just the empty-interface offset
        assert np.ptp(e64) > 1e-3
    if dtype == np.float64:
        np.testing.assert_allclose(dev, e64, rtol=1e-9, atol=1e-9)
    else:
        tol = np.array([r.tol for r in rows])
        assert (np.abs(dev - e64) <= tol).all(), (dev, e64, tol)
