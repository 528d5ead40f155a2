"""Scoring-function correctness: exact anchors + independent micro-oracles."""

import math

import numpy as np
import pytest

from lightdock_tpu import constants as C
from lightdock_tpu.engine.energy_batch import build_batch_params, batch_energy
from lightdock_tpu.engine.energy_host import HostScorer
from lightdock_tpu.scoring.models import DockingModel, build_model
from lightdock_tpu.scoring.potentials import synthetic_potential
from lightdock_tpu.scoring import tables
from lightdock_tpu.utils.pdb import parse_pdb

IDENTITY = ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0])

# Exactness anchor from the reference unit tests (src/dna.rs:571,
# src/pydock.rs:586): 1azp identity pose.
ANCHOR_1AZP = -364.88126358158974


@pytest.fixture(scope="module")
def azp_structures(reference_dir):
    rec = parse_pdb(reference_dir / "tests/1azp/1azp_receptor.pdb")
    lig = parse_pdb(reference_dir / "tests/1azp/1azp_ligand.pdb")
    return rec, lig


@pytest.mark.parametrize("method", ["dna", "pydock"])
def test_1azp_identity_anchor(azp_structures, method):
    rec, lig = azp_structures
    scorer = HostScorer(method, build_model(rec, method), build_model(lig, method),
                        use_anm=False)
    energy = scorer.energy(*IDENTITY)
    assert energy == pytest.approx(ANCHOR_1AZP, abs=1e-9)


def test_dfire_2oob_typing_and_energy_shape(reference_dir):
    """2oob builds and scores with the synthetic table (the real DCparams
    asset is not redistributed; the exact anchor 16.7540569503498 from
    src/dfire.rs:415 applies only with the real table, honored when
    LIGHTDOCK_DATA provides it)."""
    import os
    rec = build_model(parse_pdb(reference_dir / "tests/2oob/2oob_receptor.pdb"), "dfire")
    lig = build_model(parse_pdb(reference_dir / "tests/2oob/2oob_ligand.pdb"), "dfire")
    assert rec.num_atoms == 350 and lig.num_atoms == 574
    assert rec.atom_types.min() >= 0 and rec.atom_types.max() <= 168
    scorer = HostScorer("dfire", rec, lig, use_anm=False)
    energy = scorer.energy(*IDENTITY)
    assert np.isfinite(energy)
    from lightdock_tpu.scoring.potentials import dfire_data_path
    if dfire_data_path().exists():
        assert energy == pytest.approx(16.7540569503498, abs=1e-8)


def _random_dfire_models(rng, n_rec=23, n_lig=31, spread=12.0):
    def model(n):
        return DockingModel(
            method="dfire",
            coordinates=rng.uniform(-spread, spread, size=(n, 3)),
            num_anm=0,
            nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={},
            passive_restraints={},
            atom_types=rng.randint(0, 168, size=n).astype(np.int32),
        )
    return model(n_rec), model(n_lig)


def test_dfire_binning_micro_oracle():
    """HostScorer DFIRE vs a literal per-pair loop translation of the
    reference hot loop (src/dfire.rs:325-347), on random coordinates and
    the synthetic table.  Exercises the `d as usize` truncation, the
    DIST_TO_BINS lookup and the bin spill past the 20-entry stride."""
    rng = np.random.RandomState(42)
    rec, lig = _random_dfire_models(rng)
    pot = synthetic_potential()
    d2b = tables.dfire_tables()["dist_to_bins"]

    scorer = HostScorer("dfire", rec, lig, use_anm=False, potential=pot)
    fast = scorer.energy(*IDENTITY)

    score = 0.0
    for i in range(rec.num_atoms):
        for j in range(lig.num_atoms):
            diff = rec.coordinates[i] - lig.coordinates[j]
            dist2 = float(diff @ diff)
            if dist2 <= 225.0:
                d = math.sqrt(dist2) * 2.0 - 1.0
                bin_ = d2b[max(0, int(d))] - 1
                score += pot[rec.atom_types[i] * 169 * 20 + lig.atom_types[j] * 20 + bin_]
    expected = (score * 0.0157 - 4.7) * -1.0
    assert fast == pytest.approx(expected, rel=1e-12)


def test_elec_vdw_micro_oracle():
    """HostScorer DNA math vs a literal per-pair loop translation of the
    reference hot loop (src/dna.rs:471-514) on random parameters."""
    rng = np.random.RandomState(9)
    n_r, n_l = 17, 29

    def model(n):
        return DockingModel(
            method="dna",
            coordinates=rng.uniform(-15, 15, size=(n, 3)),
            num_anm=0,
            nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={},
            passive_restraints={},
            ele_charges=rng.uniform(-1, 1, size=n),
            vdw_charges=rng.uniform(0, 0.5, size=n),
            vdw_radii=rng.uniform(0.5, 2.5, size=n),
        )

    rec, lig = model(n_r), model(n_l)
    fast = HostScorer("dna", rec, lig, use_anm=False).energy(*IDENTITY)

    total_elec = total_vdw = 0.0
    for i in range(n_r):
        for j in range(n_l):
            diff = rec.coordinates[i] - lig.coordinates[j]
            d2 = float(diff @ diff)
            if d2 <= 900.0:
                e = rec.ele_charges[i] * lig.ele_charges[j] / d2
                e = min(max(e, C.ELEC_MIN_CUTOFF), C.ELEC_MAX_CUTOFF)
                total_elec += e
            if d2 <= 100.0:
                ve = math.sqrt(rec.vdw_charges[i] * lig.vdw_charges[j])
                vr = rec.vdw_radii[i] + lig.vdw_radii[j]
                p6 = vr ** 6 / d2 ** 3
                total_vdw += min(ve * (p6 * p6 - 2 * p6), 1.0)
    expected = -(total_elec * 332.0 / 4.0 + total_vdw)
    assert fast == pytest.approx(expected, rel=1e-12)


def test_elec_vdw_coincident_pair():
    """d2 == 0 / d2 -> 0 semantics match the reference's unguarded float
    math (src/dna.rs:481-504): near-coincident atoms clamp the elec term
    to the cutoff and saturate vdw, exactly coincident atoms divide by
    zero (inf -> NaN through the vdw inf - inf) — in the host oracle AND
    the batched device path alike."""
    from lightdock_tpu.engine.energy_batch import batch_energy, build_batch_params

    def model(coords):
        n = len(coords)
        return DockingModel(
            method="dna",
            coordinates=np.asarray(coords, dtype=np.float64),
            num_anm=0,
            nmodes=np.zeros((0, n, 3)),
            membrane=np.zeros(0, dtype=np.int64),
            active_restraints={},
            passive_restraints={},
            ele_charges=np.full(n, 0.5),
            vdw_charges=np.full(n, 0.2),
            vdw_radii=np.full(n, 1.5),
        )

    identity = (np.zeros(3), np.array([1.0, 0, 0, 0]), None, None)
    zeros = np.zeros((1, 0))

    # Near-coincident (d = 1e-2): elec clamps to ELEC_MAX_CUTOFF, vdw to
    # VDW_CUTOFF; both paths must take the clamp branch, not substitute a
    # safe denominator.
    rec = model([[0.0, 0.0, 0.0]])
    lig = model([[1e-2, 0.0, 0.0]])
    host = HostScorer("dna", rec, lig, use_anm=False).energy(*identity)
    p = build_batch_params(rec, lig, use_anm=False)
    dev = batch_energy(p, np.zeros((1, 3)), np.array([[1.0, 0, 0, 0]]),
                       zeros, zeros, xp=np)
    assert host == -(C.ELEC_MAX_CUTOFF * 332.0 / 4.0 + C.VDW_CUTOFF)
    assert dev[0] == pytest.approx(host, rel=1e-12)

    # Exactly coincident: the reference's division by zero propagates NaN
    # through the vdw inf - inf; the device path must agree (not mask it).
    lig0 = model([[0.0, 0.0, 0.0]])
    host0 = HostScorer("dna", rec, lig0, use_anm=False).energy(*identity)
    p0 = build_batch_params(rec, lig0, use_anm=False)
    dev0 = batch_energy(p0, np.zeros((1, 3)), np.array([[1.0, 0, 0, 0]]),
                        zeros, zeros, xp=np)
    assert np.isnan(host0) and np.isnan(dev0[0])


@pytest.mark.parametrize("method", ["dna", "pydock"])
def test_batch_energy_matches_host_oracle(azp_structures, method):
    """Batched (G poses at once) energies == per-pose host oracle."""
    rec_s, lig_s = azp_structures
    rec = build_model(rec_s, method)
    lig = build_model(lig_s, method)
    scorer = HostScorer(method, rec, lig, use_anm=False)
    params = build_batch_params(rec, lig, use_anm=False)

    rng = np.random.RandomState(0)
    g = 5
    t = rng.uniform(-20, 20, size=(g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    batched = batch_energy(params, t, q, np.zeros((g, 0)), np.zeros((g, 0)))
    for i in range(g):
        single = scorer.energy(t[i], q[i])
        assert batched[i] == pytest.approx(single, rel=1e-10, abs=1e-8)


def test_batch_energy_dfire_matches_host_oracle():
    rng = np.random.RandomState(5)
    rec, lig = _random_dfire_models(rng, 40, 55)
    pot = synthetic_potential()
    scorer = HostScorer("dfire", rec, lig, use_anm=False, potential=pot)
    params = build_batch_params(rec, lig, use_anm=False, potential=pot)
    g = 6
    t = rng.uniform(-5, 5, size=(g, 3))
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    batched = batch_energy(params, t, q, np.zeros((g, 0)), np.zeros((g, 0)))
    for i in range(g):
        assert batched[i] == pytest.approx(scorer.energy(t[i], q[i]), rel=1e-10)


