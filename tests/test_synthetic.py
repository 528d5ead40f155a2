"""Seeded synthetic complexes (lightdock_tpu.synthetic), the inputs of
chip_smoke.py and the benchmarks, at the reference examples' atom counts."""

import json

import numpy as np
import pytest

from lightdock_tpu import synthetic


@pytest.mark.parametrize("name", sorted(synthetic.SHAPES))
def test_published_shape_goes_through_setup_and_load(name, tmp_path):
    shape = synthetic.SHAPES[name]
    inputs = synthetic.make_complex(name, tmp_path, swarms=2, glowworms=6)
    assert len(inputs["positions"]) == 2
    sim = synthetic.load(inputs)   # typing resolves for every atom
    assert sim.receptor.num_atoms == shape.n_rec
    assert sim.ligand.num_atoms == shape.n_lig
    assert sim.method == shape.method
    assert sim.positions.shape == (6, 7 + (20 if shape.anm else 0))
    assert sim.receptor.membrane.size == shape.membrane
    assert len(sim.receptor.active_restraints) == shape.restraints
    assert len(sim.ligand.active_restraints) == shape.restraints
    if shape.anm:
        assert sim.receptor.nmodes.shape == (10, shape.n_rec, 3)
        assert sim.ligand.nmodes.shape == (10, shape.n_lig, 3)
    setup = json.loads((tmp_path / "setup.json").read_text())
    assert setup["use_anm"] is shape.anm
    # Poses start clear of the receptor: no ligand centre inside it.
    from lightdock_tpu.utils.positions import split_positions
    t = split_positions(sim.positions, sim.use_anm, 10, 10)[0]
    rec = sim.receptor.coordinates[:shape.n_rec - shape.membrane]
    r_rec = np.linalg.norm(rec - rec.mean(0), axis=1).max()
    assert (np.linalg.norm(t - rec.mean(0), axis=1) > r_rec).all()


def test_globule_is_compact_and_clash_free():
    rng = np.random.RandomState(0)
    xyz = synthetic.globule(1615, rng)
    assert np.abs(xyz.mean(0)).max() < 1e-9
    radius = np.linalg.norm(xyz, axis=1).max()
    assert 17.0 < radius < 23.0   # ~0.05 atoms / A^3, a 1.6k-atom protein
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert np.sqrt(d2.min()) > 1.9
    # consecutive atoms (residues) stay close in the snake order
    assert np.median(np.linalg.norm(np.diff(xyz, axis=0), axis=1)) < 3.5


def test_anm_modes_are_smooth_unit_fields():
    rng = np.random.RandomState(1)
    xyz = synthetic.globule(400, rng)
    modes = synthetic.anm_modes(xyz, 10, rng)
    assert modes.shape == (10, 400, 3)
    np.testing.assert_allclose(np.linalg.norm(modes.reshape(10, -1), axis=1), 1.0)
    # neighbours move together: displacement differences between adjacent
    # lattice atoms are much smaller than the displacements themselves
    i = np.argsort(np.linalg.norm(xyz[1:] - xyz[:-1], axis=1))[:100]
    step = np.abs(modes[:, i + 1] - modes[:, i]).mean()
    assert step < 0.5 * np.abs(modes).mean()


def test_same_seed_same_inputs(tmp_path):
    a = synthetic.make_complex("1czy", tmp_path / "a", swarms=1, glowworms=4)
    b = synthetic.make_complex("1czy", tmp_path / "b", swarms=1, glowworms=4)
    for key in ("rec.pdb", "lig.pdb", "init/initial_positions_0.dat"):
        assert (tmp_path / "a" / key).read_text() == (tmp_path / "b" / key).read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "rec_nm.npy"),
                                  np.load(tmp_path / "b" / "rec_nm.npy"))
    assert a["method"] == b["method"] == "dfire"
