#!/usr/bin/env python3
"""Smoke run of the docking engine on one NVIDIA GPU.

Drives the main path end to end, in ONE process, through the entry points
a user calls (``lightdock-tpu-tools setup``, ``lightdock-tpu``,
``lightdock-tpu-analysis``), on seeded synthetic complexes at the
reference examples' atom counts (lightdock_tpu.synthetic):

  a  1ppe shape, one swarm, 200 glowworms x 100 steps, snapshots on
  b  1ppe shape, all 10 swarms through the multi-swarm farm, then
     ``lightdock-tpu-analysis all``
  c  1azp shape, DNA scoring with ANM 10+10, 100 steps
  d  1k4c shape, DFIRE with membrane and restraints, 10 steps (the memory
     check: chosen energy chunk and peak device memory are printed)
  e  oracle: for every phase, >= 16 final poses scored by the production
     f32 device path and by the f64 host oracle (engine.energy_host)
  k  GPU-only checks: the compiled DFIRE kernel against interpret mode and
     XLA at real widths, and the bias einsums at default vs full precision

The global matmul precision stays at its default, so the run shows what
TF32 does.  Any failed phase exits non-zero.  The last line of standard
output is one JSON object naming the device.

    python chip_smoke.py               # one GPU, phases a-e and k
    python chip_smoke.py --four-cards  # the two multi-device comparisons
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile
import time
import typing

import numpy as np

from lightdock_tpu import constants as C


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Run sizes; FULL is what the script runs, tests shrink it."""

    glowworms: int = 200
    swarms: int = 10
    steps: int = 100
    steps_1k4c: int = 10
    oracle_poses: int = 16
    farm_swarms: int = 8       # --four-cards: 2 swarms per card
    shapes: tuple = ()         # {name: ComplexShape} overrides (tests)

    def shape(self, name):
        from lightdock_tpu import synthetic

        return dict(self.shapes).get(name, synthetic.SHAPES[name])


FULL = Sizes()


def log(*a):
    print(*a, flush=True)


# -- f64 oracle with a derived tolerance --------------------------------------

# Rounding of an f32 pair-energy sum relative to the sum of |pair terms|:
# DFIRE terms are table values, so only the f32 accumulation rounds (a
# log2(1e7)-deep tree of 2^-24 steps is ~1.5e-6); elec/vdw terms also carry
# the f32 rounding of d2 amplified up to 12x by the d^-12 repulsion
# (coordinates of ~100 A hold ~6e-6 A of rounding; at d = 3 A that is
# 2e-6 relative in d, 2.4e-5 in the term).
REL_TOL = {"dfire": 1e-5, "dna": 1e-4, "pydock": 1e-4}
# Rounding of an f32 transformed coordinate against f64, in units of
# 2^-24 |x|: rotation matrix from the quaternion, 3-term products,
# translation, ANM sum.
COORD_ULPS = 16.0
# Two f32 paths that run the same pose transform (the compiled kernel, its
# interpret mode, the XLA path) may still fuse it differently: their
# coordinates differ by at most the final multiply-adds' rounding.
COORD_ULPS_PATHS = 2.0


class OracleBound(typing.NamedTuple):
    e64: float         # f64 oracle energy
    tol: float         # bound on |E_f32 - e64|
    n_near: int        # pairs within the f32 band of a bin edge or cutoff
    de_edges: float    # worst effect of those pairs on the pair sum
    tol_paths: float   # bound on |E_a - E_b| for two f32 paths


def _d2_halfwidth(d2, coord_max, ulps=COORD_ULPS):
    """Bound on |d2 - d2'| for a pair at squared distance d2 when each
    coordinate of both atoms is off by <= eps_c: the distance moves by
    <= 2 sqrt(3) eps_c, plus the rounding of d2 itself."""
    eps_c = ulps * 2.0 ** -24 * coord_max
    return 2.0 * np.sqrt(d2) * 2.0 * np.sqrt(3.0) * eps_c + 1e-6 * d2


def _uncertain_iface(near, certain, groups):
    """Number of atom groups (residues or beads) whose interface flag could
    flip: no atom certainly inside, at least one atom near the edge."""
    n = 0
    for idx in groups:
        idx = np.asarray(idx, dtype=np.int64)
        if not certain[idx].any() and near[idx].any():
            n += 1
    return n


def _fraction_hit(iface, groups):
    """Share of the restraint residues with an atom in the interface (the
    bias's fr / fl)."""
    groups = list(groups)
    if not groups:
        return 0.0
    return float(np.mean([iface[np.asarray(g, np.int64)].any() for g in groups]))


def oracle_bounds(sim, t, q, a_rec, a_lig) -> OracleBound:
    """f64 energy of one pose plus tolerances for the f32 device paths.

    Pairs whose f64 d2 lies within the f32 rounding band of a bin edge or
    cutoff may land on the other side on the device; n_near counts them,
    de_edges bounds what they can move the pair sum (every such pair
    flipped the worst way).  ``tol`` adds the summation rounding (REL_TOL
    of the summed |terms|), scales by the pose's own restraint gain
    1 + fr + fl (from the f64 interface flags, widened by any residue whose
    flag could flip), and adds the bias jump such residues and membrane
    beads can cause.  ``tol_paths`` bounds two f32 paths against each
    other: the pairs each may flip lie within a COORD_ULPS_PATHS band, and
    each path rounds its own sum.
    """
    from lightdock_tpu.engine.energy_host import pose_transform

    rec_m, lig_m = sim.receptor, sim.ligand
    hs = sim.host_scorer()
    e64 = hs.energy(t, q, a_rec, a_lig)
    rec = pose_transform(rec_m, a_rec if sim.use_anm else None)
    lig = pose_transform(lig_m, a_lig if sim.use_anm else None, t, q)
    coord_max = max(np.abs(rec).max(), np.abs(lig).max())
    diff = rec[:, None, :] - lig[None, :, :]
    d2 = np.einsum("ijk,ijk->ij", diff, diff)
    hw = _d2_halfwidth(d2, coord_max)
    hw_paths = _d2_halfwidth(d2, coord_max, COORD_ULPS_PATHS)

    if sim.method == "dfire":
        from lightdock_tpu.ops.pallas_energy import NUM_SLOTS, slot_table

        table = slot_table(hs.potential.astype(np.float64),
                           np.asarray(hs.dist_to_bins), xp=np).reshape(
            C.DFIRE_NUM_ATOM_TYPES, C.DFIRE_NUM_ATOM_TYPES, NUM_SLOTS)
        pair_t = table[rec_m.atom_types[:, None], lig_m.atom_types[None, :]]
        inside = d2 <= C.DFIRE_DIST_CUTOFF2
        d = np.sqrt(d2) * 2.0 - 1.0
        slot = np.clip(np.trunc(d), 0, NUM_SLOTS - 1).astype(np.int64)
        terms = np.take_along_axis(pair_t, slot[..., None], -1)[..., 0]
        abs_sum = np.abs(terms[inside]).sum() * C.DFIRE_SCALE
        # Nearest slot edge: d2 = ((m + 1) / 2)^2, m = 1..29; the cutoff
        # (d2 = 225) is the m = 29 edge.
        m = np.clip(np.rint(d), 1, NUM_SLOTS - 1).astype(np.int64)
        edge = ((m + 1) / 2.0) ** 2
        lo = np.take_along_axis(pair_t, (m - 1)[..., None], -1)[..., 0]
        hi = np.take_along_axis(pair_t, m[..., None], -1)[..., 0]
        jump = np.where(m == NUM_SLOTS - 1, np.maximum(np.abs(lo), np.abs(hi)),
                        np.abs(hi - lo)) * C.DFIRE_SCALE
        near = np.abs(d2 - edge) <= hw
        de_edges = (jump * near).sum()
        de_paths = (jump * (np.abs(d2 - edge) <= hw_paths)).sum()
        raw = (terms * inside).sum()
        score = (raw * C.DFIRE_SCALE - C.DFIRE_OFFSET) * -1.0
        iface_edge = ((C.INTERFACE_CUTOFF + 1.0) / 2.0) ** 2
    else:
        elec = (rec_m.ele_charges[:, None] * lig_m.ele_charges[None, :]) / d2
        elec = np.clip(elec, C.ELEC_MIN_CUTOFF, C.ELEC_MAX_CUTOFF) * (
            C.FACTOR / C.EPSILON)
        vdw_e = np.sqrt(rec_m.vdw_charges[:, None] * lig_m.vdw_charges[None, :])
        r2 = (rec_m.vdw_radii[:, None] + lig_m.vdw_radii[None, :]) ** 2
        p6 = (r2 / d2) ** 3
        vdw = np.minimum(vdw_e * (p6 * p6 - 2.0 * p6), C.VDW_CUTOFF)
        in_e = d2 <= C.ELEC_DIST_CUTOFF2
        in_v = d2 <= C.VDW_DIST_CUTOFF2
        abs_sum = np.abs(elec[in_e]).sum() + np.abs(vdw[in_v]).sum()

        def edges(band):
            near_e = np.abs(d2 - C.ELEC_DIST_CUTOFF2) <= band
            near_v = np.abs(d2 - C.VDW_DIST_CUTOFF2) <= band
            return near_e | near_v, ((np.abs(elec) * near_e).sum()
                                     + (np.abs(vdw) * near_v).sum())

        near, de_edges = edges(hw)
        de_paths = edges(hw_paths)[1]
        score = -((elec * in_e).sum() + (vdw * in_v).sum())
        iface_edge = C.INTERFACE_CUTOFF2

    # Bias: score * (1 + fr + fl) - membrane penalty.  An interface flag
    # near its edge can move fr/fl by one residue or the penalty by one bead.
    iface = d2 <= iface_edge
    near_if = np.abs(d2 - iface_edge) <= hw
    certain_if = d2 < iface_edge - hw
    if sim.method == "dfire":
        near_if &= d2 <= C.DFIRE_DIST_CUTOFF2
    res_r = list(rec_m.active_restraints.values())
    res_l = list(lig_m.active_restraints.values())
    unc_r = _uncertain_iface(near_if.any(1), certain_if.any(1), res_r)
    unc_l = _uncertain_iface(near_if.any(0), certain_if.any(0), res_l)
    unc_m = _uncertain_iface(near_if.any(1), certain_if.any(1),
                             [[i] for i in rec_m.membrane])
    dfrac = (unc_r / len(res_r) if res_r else 0.0) + (unc_l / len(res_l) if res_l else 0.0)
    dpen = (C.MEMBRANE_PENALTY_SCORE * unc_m / rec_m.membrane.size
            if rec_m.membrane.size else 0.0)
    gain = (1.0 + _fraction_hit(iface.any(1), res_r)
            + _fraction_hit(iface.any(0), res_l) + dfrac)
    rounding = REL_TOL[sim.method] * (abs_sum + abs(score))
    tol = gain * (de_edges + rounding) + abs(score) * dfrac + dpen
    tol_paths = gain * (de_paths + 2.0 * rounding) + abs(score) * dfrac + dpen
    return OracleBound(e64, tol, int(near.sum()), float(de_edges), tol_paths)


def device_energies(sim, t, q, a_rec, a_lig, energy_mode="auto"):
    """Production f32 device scores of the given poses: the energy path a
    CLI run with this simulation takes."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.engine.gso_jax import GsoJaxRunner

    g = t.shape[0]
    pos = np.concatenate([t, q, a_rec, a_lig], axis=1)
    runner = GsoJaxRunner(sim.batch_params(dtype=np.float32), pos, sim.seed,
                          sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                          dtype=jnp.float32, energy_mode=energy_mode)
    st = runner.state
    out = jax.jit(runner.energy_fn)(runner.params, st.t, st.q, st.a_rec,
                                    st.a_lig)
    assert out.shape == (g,), out.shape
    return np.asarray(out, np.float64), runner.energy_mode


def oracle_check(label, sim, poses, sizes, energy_mode="auto"):
    """Phase e for one phase's final poses: device f32 vs f64 oracle."""
    from lightdock_tpu.utils.positions import split_positions

    poses = poses[:sizes.oracle_poses]
    t, q, ar, al = split_positions(poses, sim.use_anm, sim.setup.anm_rec,
                                   sim.setup.anm_lig)
    dev, mode = device_energies(sim, t, q, ar, al, energy_mode)
    rows = [oracle_bounds(sim, t[i], q[i], ar[i], al[i])
            for i in range(len(poses))]
    e64 = np.array([r.e64 for r in rows])
    tol = np.array([r.tol for r in rows])
    err = np.abs(dev - e64)
    assert np.isfinite(dev).all(), dev
    n_near = sum(r.n_near for r in rows)
    n_pairs = len(poses) * sim.receptor.num_atoms * sim.ligand.num_atoms
    log(f"[e] {label}: {len(poses)} poses, energy path {mode}: max |E32-E64| "
        f"{err.max():.3e} (max rel {np.max(err / np.maximum(1, np.abs(e64))):.2e}); "
        f"tolerance min/max {tol.min():.3e}/{tol.max():.3e}; pairs within the "
        f"f32 band of a bin edge or cutoff: {n_near} of {n_pairs} "
        f"({n_near / n_pairs:.2e}), worst-case effect "
        f"{max(r.de_edges for r in rows):.3e}")
    bad = np.nonzero(err > tol)[0]
    assert bad.size == 0, (label, bad, dev[bad], e64[bad], tol[bad])
    return {"max_abs_err": float(err.max()), "n_near_edge": int(n_near),
            "max_tol": float(tol.max())}


# -- phases -------------------------------------------------------------------


def _timed(fn, *a):
    t0 = time.perf_counter()
    rc = fn(*a)
    assert rc == 0, rc
    return time.perf_counter() - t0


def _final_poses(swarm_dir, step):
    from lightdock_tpu.utils.output import read_gso_output

    poses, *_ = read_gso_output(pathlib.Path(swarm_dir) / f"gso_{step}.out")
    return poses


def _cli_run(inputs, steps, out, swarm=0, extra=()):
    from lightdock_tpu import cli

    argv = [inputs["setup"], inputs["positions"][swarm], str(steps),
            inputs["method"], "--output-dir", str(out),
            "--anm-dir", inputs["anm_dir"], *extra]
    return _timed(cli.main, argv)


def phase_single(name, workdir, sizes, steps):
    """Phases a, c, d: one swarm through the CLI, twice (the first run
    includes compilation, the second reuses it)."""
    from lightdock_tpu import synthetic

    inputs = synthetic.make_complex(sizes.shape(name), pathlib.Path(workdir) / name,
                                    swarms=1, glowworms=sizes.glowworms)
    out = pathlib.Path(workdir) / name / "swarm_0"
    first = _cli_run(inputs, steps, out)
    second = _cli_run(inputs, steps, out)
    assert (out / f"gso_{steps}.out").exists()
    g = sizes.glowworms
    res = {"first_run_s": first, "run_s": second,
           "poses_per_s": g * steps / second, "compile_s_est": first - second}
    log(f"[{name}] {g} glowworms x {steps} steps: first run (compile + run) "
        f"{first:.2f}s, second run {second:.2f}s = {res['poses_per_s']:.0f} "
        f"poses/s")
    sim = synthetic.load(inputs)
    res["oracle"] = oracle_check(name, sim, _final_poses(out, steps), sizes)
    return res, sim


def phase_a(workdir, sizes=FULL):
    return phase_single("1ppe", workdir, sizes, sizes.steps)[0]


def phase_b(workdir, sizes=FULL):
    """All swarms of the 1ppe shape through the multi-swarm farm, then the
    analysis CLI."""
    from lightdock_tpu import cli_analysis, synthetic

    root = pathlib.Path(workdir) / "1ppe_farm"
    inputs = synthetic.make_complex(sizes.shape("1ppe"), root,
                                    swarms=sizes.swarms,
                                    glowworms=sizes.glowworms)
    glob = str(root / "init" / "initial_positions_*.dat")
    argv = [inputs["setup"], glob, str(sizes.steps), "dfire",
            "--output-dir", str(root)]
    from lightdock_tpu import cli

    first = _timed(cli.main, argv)
    second = _timed(cli.main, argv)
    t_an = _timed(cli_analysis.main, ["all", str(root), str(sizes.steps),
                                      "--setup", inputs["setup"]])
    ranked = (root / "rank_by_scoring.list").read_text().splitlines()
    assert len(ranked) > 1, ranked
    assert (root / "top").is_dir()
    total = sizes.swarms * sizes.glowworms * sizes.steps
    res = {"first_run_s": first, "run_s": second,
           "poses_per_s": total / second, "analysis_s": t_an}
    log(f"[1ppe farm] {sizes.swarms} swarms x {sizes.glowworms} x "
        f"{sizes.steps} steps: first run {first:.2f}s, second {second:.2f}s "
        f"= {res['poses_per_s']:.0f} poses/s; analysis all {t_an:.2f}s")
    sim = synthetic.load(inputs)
    swarm = sizes.swarms - 1
    res["oracle"] = oracle_check(f"1ppe farm swarm {swarm}", sim,
                                 _final_poses(root / f"swarm_{swarm}",
                                              sizes.steps), sizes)
    return res


def phase_c(workdir, sizes=FULL):
    return phase_single("1azp", workdir, sizes, sizes.steps)[0]


def phase_d(workdir, sizes=FULL):
    """The 1k4c shape: the memory check."""
    import jax

    from lightdock_tpu.cli import energy_budget_bytes, pick_energy_chunk

    shape = sizes.shape("1k4c")
    chunk = pick_energy_chunk(shape.n_rec * shape.n_lig, sizes.glowworms, 4,
                              energy_budget_bytes())
    res, _ = phase_single("1k4c", workdir, sizes, sizes.steps_1k4c)
    stats = jax.devices()[0].memory_stats() or {}
    res["energy_chunk"] = chunk
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    res["bytes_limit"] = stats.get("bytes_limit")
    log(f"[1k4c] XLA energy chunk {chunk} poses (budget "
        f"{energy_budget_bytes() / 1e9:.2f} GB); peak device memory "
        f"{res['peak_bytes_in_use']} of {res['bytes_limit']} bytes")
    return res


# -- GPU-only checks (also the tests of tests/test_gpu.py) ---------------------


def _contact_poses(sim, n):
    """The first n poses of the simulation in contact with the receptor
    (synthetic.contact_positions), so the pair sums are dense."""
    from lightdock_tpu import synthetic
    from lightdock_tpu.utils.positions import split_positions

    return split_positions(synthetic.contact_positions(sim)[:n], sim.use_anm,
                           sim.setup.anm_rec, sim.setup.anm_lig)


def check_kernel_compiled(sim, n_poses=16, interpret_check=True):
    """The compiled DFIRE kernel against the f64 oracle (within the derived
    tolerance), and against interpret mode and the XLA path (within the
    bound for two f32 paths: summation rounding plus the pairs within a
    few ulps of a bin edge)."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.engine.energy_pallas import (make_pallas_energy_fn,
                                                    spatial_sort_params)
    from lightdock_tpu.engine.gso_jax import batch_energy_chunked, device_params

    t, q, ar, al = _contact_poses(sim, n_poses)
    pose = [jnp.asarray(x, jnp.float32) for x in (t, q, ar, al)]
    host = sim.batch_params(dtype=np.float32)
    srt = spatial_sort_params(host)
    out = {"kernel": make_pallas_energy_fn(srt)(device_params(srt, np.float32), *pose)}
    if interpret_check:
        out["interpret"] = make_pallas_energy_fn(srt, interpret=True)(
            device_params(srt, np.float32), *pose)
    out["xla-gather"] = jax.jit(batch_energy_chunked)(
        device_params(host, np.float32), *pose)
    rows = [oracle_bounds(sim, t[i], q[i], ar[i], al[i]) for i in range(n_poses)]
    e64 = np.array([r.e64 for r in rows])
    tol = np.array([r.tol for r in rows])
    tol_paths = np.array([r.tol_paths for r in rows])
    out = {name: np.asarray(e, np.float64) for name, e in out.items()}
    errs = {}
    for name, e in out.items():
        errs[name] = float(np.abs(e - e64).max())
        assert (np.abs(e - e64) <= tol).all(), (name, e, e64, tol)
    for name in out:
        if name != "kernel":
            d = np.abs(out["kernel"] - out[name])
            errs[f"kernel-vs-{name}"] = float(d.max())
            assert (d <= tol_paths).all(), (name, d, tol_paths)
    errs["max_tol"], errs["max_tol_paths"] = float(tol.max()), float(tol_paths.max())
    return errs


def check_bias_precision(sim, n_poses=64, seed=0):
    """The restraint and membrane einsums of the bias (energy_batch._bias,
    sharded._sharded_bias) give bit-identical results at default matmul
    precision and at "highest": their operands are 0/1 (exact in TF32)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from lightdock_tpu.engine.energy_batch import _bias
    from lightdock_tpu.engine.gso_jax import device_params
    from lightdock_tpu.parallel import sharded
    from lightdock_tpu.parallel.mesh import ATOM_AXIS, make_mesh

    rng = np.random.RandomState(seed)
    p = device_params(sim.batch_params(dtype=np.float32), np.float32)
    nr, nl = sim.receptor.num_atoms, sim.ligand.num_atoms
    score = jnp.asarray(rng.uniform(-50, 50, n_poses), jnp.float32)
    ifr = jnp.asarray(rng.rand(n_poses, nr) < 0.05, jnp.float32)
    ifl = jnp.asarray(rng.rand(n_poses, nl) < 0.05, jnp.float32)
    raw = jnp.asarray(rng.uniform(-500, 500, n_poses), jnp.float32)
    mesh = make_mesh(n_swarm=1, n_atoms=1, devices=jax.devices()[:1])
    specs = sharded.params_atom_specs(p)
    sb = jax.shard_map(
        lambda pl_, r, a, b: sharded._sharded_bias(pl_, r, a, b, ATOM_AXIS),
        mesh=mesh, in_specs=(specs, P(), P(ATOM_AXIS), P()), out_specs=P())
    results = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(None if prec == "default" else prec):
            results[prec] = (
                np.asarray(jax.jit(lambda s, a, b: _bias(p, s, a, b, jnp))(
                    score, ifr, ifl)),
                np.asarray(jax.jit(sb)(p, raw, ifr, ifl)))
    for a, b in zip(results["default"], results["highest"]):
        np.testing.assert_array_equal(a, b)
    return True


def phase_k(workdir, sizes=FULL):
    """GPU-only checks at real widths."""
    from lightdock_tpu import synthetic

    res = {}
    for name in ("1ppe", "2uuy", "1k4c"):
        inputs = synthetic.make_complex(sizes.shape(name),
                                        pathlib.Path(workdir) / f"k_{name}",
                                        swarms=1, glowworms=sizes.glowworms)
        sim = synthetic.load(inputs)
        res[name] = check_kernel_compiled(sim, sizes.oracle_poses,
                                          interpret_check=name != "1k4c")
        log(f"[k] {name}: kernel/interpret/xla vs f64 max |err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in res[name].items()))
        if name == "1k4c":
            res["bias_precision_identical"] = check_bias_precision(sim)
            log("[k] bias einsums: default precision == highest (bitwise)")
    return res


# -- four cards -----------------------------------------------------------------


def four_card_farm(workdir, sizes=FULL, devices=None):
    """The multi-swarm farm over every card against the same swarms on one
    card: each card holds its own swarms, and the results are bit-identical
    (swarms are independent and every card runs the same program on its
    own swarms; on one H100 and on four they were)."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu import synthetic
    from lightdock_tpu.parallel.farm import SwarmFarmRunner
    from lightdock_tpu.utils.positions import parse_positions

    devices = list(devices if devices is not None else jax.devices())
    inputs = synthetic.make_complex(sizes.shape("1ppe"),
                                    pathlib.Path(workdir) / "4c_1ppe",
                                    swarms=sizes.farm_swarms,
                                    glowworms=sizes.glowworms)
    sim = synthetic.load(inputs)
    pos = [parse_positions(p) for p in inputs["positions"]]
    kw = dict(seed=sim.seed, use_anm=sim.use_anm, anm_rec=0, anm_lig=0,
              dtype=jnp.float32, output_root=None, energy_mode="auto")
    params = sim.batch_params(dtype=np.float32)
    runs = {}
    for label, devs in (("all", devices), ("one", devices[:1])):
        farm = SwarmFarmRunner(params, pos, list(range(len(pos))),
                               devices=devs, **kw)
        t0 = time.perf_counter()
        st, outs = farm.run_segmented(sizes.steps, segment=10)
        jax.block_until_ready(st)
        runs[label] = (st, outs, time.perf_counter() - t0)
    (st4, outs4, t4), (st1, outs1, t1) = runs["all"], runs["one"]
    per_card = {str(shard.device): shard.data.shape[0]
                for shard in st4.scoring.addressable_shards}
    peaks = {str(d): (d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices}
    same = {k: bool(np.array_equal(np.asarray(getattr(st4, k)),
                                   np.asarray(getattr(st1, k))))
            for k in ("t", "q", "scoring", "luciferin", "num_neighbors")}
    same["last_segment_scores"] = bool(np.array_equal(
        np.asarray(outs4.scoring), np.asarray(outs1.scoring)))
    err = float(np.abs(np.asarray(st4.scoring) - np.asarray(st1.scoring)).max())
    log(f"[4c] farm {len(pos)} swarms x {sizes.glowworms} x {sizes.steps} "
        f"steps on {len(devices)} cards {t4:.2f}s vs one card {t1:.2f}s; "
        f"bit-identical {same}; max |score diff| {err:.3e}; swarms per card "
        f"{per_card}; peak bytes per card {peaks}")
    want = len(pos) // len(devices)
    assert len(per_card) == len(devices), per_card
    assert all(v == want for v in per_card.values()), per_card
    assert all(same.values()), same
    return {"identical": same, "max_score_diff": err,
            "per_card_swarms": per_card, "peak_bytes": peaks,
            "s_all": t4, "s_one": t1}


def four_card_atom_sharded(workdir, sizes=FULL, devices=None):
    """Receptor atoms sharded over a 2 x 2 (swarm, atoms) mesh at the 1k4c
    shape (psum/pmax across cards) against the one-card farm."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu import synthetic
    from lightdock_tpu.cli import energy_budget_bytes, pick_energy_chunk
    from lightdock_tpu.parallel.farm import run_swarm_farm
    from lightdock_tpu.utils.output import read_gso_output
    from lightdock_tpu.utils.positions import parse_positions

    devices = list(devices if devices is not None else jax.devices())
    inputs = synthetic.make_complex(sizes.shape("1k4c"),
                                    pathlib.Path(workdir) / "4c_1k4c",
                                    swarms=2, glowworms=sizes.glowworms)
    sim = synthetic.load(inputs)
    pos = [parse_positions(p) for p in inputs["positions"]]
    params = sim.batch_params(dtype=np.float32)
    # The one-card farm scores all 2 x 200 poses in one batch: bound its
    # (chunk, Nr, Nl) intermediates like the CLI does.
    chunk = pick_energy_chunk(sim.receptor.num_atoms * sim.ligand.num_atoms,
                              2 * sizes.glowworms, 4, energy_budget_bytes())
    outs = {}
    for label, shards, devs in (("2x2", 2, devices), ("one", 1, devices[:1])):
        root = pathlib.Path(workdir) / f"4c_out_{label}"
        t0 = time.perf_counter()
        run_swarm_farm(params, pos, [0, 1], sim.seed, sizes.steps_1k4c,
                       sim.use_anm, 0, 0, jnp.float32, output_root=str(root),
                       energy_mode="xla", n_atom_shards=shards, devices=devs,
                       energy_chunk=chunk)
        snaps = [read_gso_output(root / f"swarm_{i}" / f"gso_{sizes.steps_1k4c}.out")
                 for i in (0, 1)]
        outs[label] = (time.perf_counter() - t0,
                       np.concatenate([s_[0] for s_ in snaps]),
                       np.concatenate([s_[2] for s_ in snaps]),
                       np.concatenate([s_[4] for s_ in snaps]))
    (t2, pose2, nn2, sc2), (t1, pose1, nn1, sc1) = outs["2x2"], outs["one"]
    d = float(np.abs(sc2 - sc1).max())
    dpose = float(np.abs(pose2 - pose1).max())
    # psum over two receptor halves reassociates the f32 pair sum and the
    # 2-D path fuses the movement phase differently: scores agree to f32
    # summation rounding (1e-4 of the largest score, REL_TOL["dfire"] with
    # a 10x margin for the steps it compounds over), poses to f32 movement
    # rounding (0.5 A steps on ~50 A coordinates: ~4e-6 A per operation,
    # ~100 operations over 10 steps).  A selection flip (a different
    # neighbour count) would send the trajectories apart: none may occur
    # (on four H100s there were none, and the score difference was 4.8e-7).
    tol, pose_tol = 1e-4 * max(1.0, float(np.abs(sc1).max())), 1e-3
    flips = int((nn2 != nn1).sum())
    log(f"[4c] 1k4c atom-sharded 2x2 mesh {t2:.2f}s vs one card {t1:.2f}s: "
        f"max |score diff| {d:.3e} (tolerance {tol:.3e}), max |pose diff| "
        f"{dpose:.3e} (tolerance {pose_tol:.0e}), bit-identical "
        f"{bool(d == 0 and dpose == 0)}; glowworms with other neighbour "
        f"counts: {flips}")
    assert flips == 0 and d <= tol and dpose <= pose_tol, (d, dpose, flips)
    return {"max_score_diff": d, "tol": tol, "max_pose_diff": dpose,
            "selection_flips": flips}


def four_cards(workdir, sizes=FULL, devices=None):
    """The two multi-device comparisons of ``--four-cards``."""
    return {"farm": four_card_farm(workdir, sizes, devices),
            "atom_sharded": four_card_atom_sharded(workdir, sizes, devices)}


# -- entry -----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the two multi-device comparisons")
    args = ap.parse_args(argv)

    from lightdock_tpu.utils.compile_cache import setup_compile_cache

    cache = setup_compile_cache()
    import jax

    from lightdock_tpu.scoring.potentials import dfire_data_path
    from lightdock_tpu.utils import native
    from lightdock_tpu.utils.device_info import nvidia_smi_line, require_gpu

    device = require_gpu()
    log(f"jax {jax.__version__}; device {device}; compile cache {cache}")
    log(f"native IO library: {'used' if native.available() else 'unavailable, pure-Python IO'}; "
        f"DFIRE table: {'real DCparams' if dfire_data_path().exists() else 'deterministic synthetic'}")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            assert device["count"] == 4, device
            results["four_cards"] = four_cards(tmp)
        else:
            for name, phase in (("a", phase_a), ("b", phase_b), ("c", phase_c),
                                ("d", phase_d), ("k", phase_k)):
                t0 = time.perf_counter()
                results[name] = phase(tmp)
                log(f"phase {name} done in {time.perf_counter() - t0:.1f}s")
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / ("chip_smoke_4c.json" if args.four_cards else "chip_smoke.json")
     ).write_text(json.dumps(results, indent=1, default=str))
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
