#!/usr/bin/env python3
"""Precision fidelity: the f32 device path vs the f64 reference contract.

The reference's hot loop is all-f64 (reference src/dfire.rs:325-347) and
its shipped goldens are f64 trajectories; the production device path runs
f32.  This measures exactly what that costs (SURVEY §7 precision policy),
on the fully-verifiable 1azp DNA workload and the 1ppe DFIRE workload
(synthetic table):

A. ENERGY accuracy — per-pose |f32 - f64| / |f64| at the initial poses
   for the f32 XLA batch path and (DFIRE on a GPU) the f32 pair kernel.
B. TRAJECTORY horizon — the f32 engine vs a same-machine f64 run at the
   saved steps (1, 10, ..., 100): first saved step whose rendered
   gso_N.out differs, max |dscore| / max |dt| per saved step (sidecars).
C. RESULT equivalence at step 100 — best score, top-10 pose-id overlap,
   Kendall tau of the full rank order, BSAS cluster representatives.

The f64 leg runs on the CPU in this process, which never touches the GPU;
the f32 leg runs in a child process on the session backend (one process
per card: the child alone opens it).  Run once on a GPU host for the
device numbers and once with --platform cpu for the CPU baseline.  Results
merge into --out keyed by backend+engine.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REFERENCE = pathlib.Path(os.environ.get("LIGHTDOCK_REFERENCE",
                                        "/root/reference"))
SAVED_STEPS = [1] + list(range(10, 101, 10))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_example(name):
    from lightdock_tpu.simulation import load_simulation

    ex = REFERENCE / "example" / name
    method = {"1azp": "dna", "1ppe": "dfire"}[name]
    return load_simulation(ex / "setup.json", ex / "initial_positions_0.dat",
                           method, anm_dir=ex), method


def run_engine(sim, outdir, dtype_name, energy_mode, steps=100,
               energy_dtype=None, seed=None):
    import jax.numpy as jnp

    from lightdock_tpu.engine.gso_jax import GsoJaxRunner

    dt = {"f32": jnp.float32, "f64": jnp.float64, None: None}
    runner = GsoJaxRunner(sim.batch_params(), sim.positions,
                          seed if seed is not None else sim.seed,
                          sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                          output_directory=str(outdir), dtype=dt[dtype_name],
                          energy_mode=energy_mode,
                          energy_chunk=25 if energy_mode == "xla" else 0,
                          energy_dtype=dt[energy_dtype])
    runner.run_segmented(steps, 10)


def kendall_tau(a, b):
    """Kendall rank correlation of two score vectors (O(n^2), n<=200)."""
    import numpy as np
    n = len(a)
    conc = disc = 0
    for i in range(n):
        da = a[i] - a[i + 1:]
        db = b[i] - b[i + 1:]
        s = np.sign(da) * np.sign(db)
        conc += int((s > 0).sum())
        disc += int((s < 0).sum())
    tot = n * (n - 1) // 2
    return (conc - disc) / tot if tot else 1.0


def pose_coords(sim, state):
    """Transformed ligand coordinates (G, Nl, 3) for cluster comparison."""
    import jax.numpy as jnp
    import numpy as np

    from lightdock_tpu.engine.energy_batch import batch_pose_coords

    p = sim.batch_params(dtype=np.float64)
    _, lig = batch_pose_coords(
        p, jnp.asarray(state["t"], jnp.float64),
        jnp.asarray(state["q"], jnp.float64),
        jnp.asarray(state["a_rec"], jnp.float64),
        jnp.asarray(state["a_lig"], jnp.float64), xp=jnp)
    return np.asarray(lig)


def f64_ref_energies(sim):
    """The f64 oracle energies at the initial poses (CPU, x64 on)."""
    import jax.numpy as jnp
    import numpy as np

    from lightdock_tpu.engine.energy_batch import batch_energy
    from lightdock_tpu.engine.gso_jax import device_params, init_state

    pos = sim.positions
    st = init_state(pos, sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                    dtype=jnp.float64)
    p64 = device_params(sim.batch_params(), np.float64)
    return np.asarray(batch_energy(p64, st.t, st.q, st.a_rec, st.a_lig,
                                   xp=jnp), np.float64)


def energy_accuracy(sim, method, ref):
    """Part A: per-pose initial-energy relative error vs the f64 oracle
    (``ref`` precomputed on CPU so this runs x64-free on any backend)."""
    import jax.numpy as jnp
    import numpy as np

    from lightdock_tpu.engine.energy_pallas import (make_pallas_energy_fn,
                                                    spatial_sort_params)
    from lightdock_tpu.engine.gso_jax import device_params, init_state
    from lightdock_tpu.engine.energy_batch import batch_energy
    import jax

    pos = sim.positions
    st32 = init_state(pos, sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                      dtype=jnp.float32)
    params32 = sim.batch_params(dtype=np.float32)
    p32 = device_params(params32, np.float32)
    xla32 = np.asarray(batch_energy(p32, st32.t, st32.q, st32.a_rec,
                                    st32.a_lig, xp=jnp), np.float64)

    def rel(e):
        denom = np.maximum(np.abs(ref), 1e-6)
        return np.abs(e - ref) / denom

    out = {"xla_f32_rel_err": {"max": float(rel(xla32).max()),
                               "median": float(np.median(rel(xla32)))}}
    if method == "dfire" and jax.default_backend() == "gpu":
        sorted32 = spatial_sort_params(params32)
        efn = make_pallas_energy_fn(sorted32)
        dp32 = device_params(sorted32, np.float32)
        pal32 = np.asarray(efn(dp32, st32.t, st32.q, st32.a_rec, st32.a_lig),
                           np.float64)
        out["kernel_f32_rel_err"] = {"max": float(rel(pal32).max()),
                                     "median": float(np.median(rel(pal32)))}
    return out


def compare_runs(dir64, dir32, sim):
    """Parts B + C from the two output directories."""
    import numpy as np

    from lightdock_tpu.analysis import cluster_bsas
    from lightdock_tpu.utils.output import read_state_sidecar

    horizon = []
    first_diff = None
    for step in SAVED_STEPS:
        f64 = pathlib.Path(dir64) / f"gso_{step}.out"
        f32 = pathlib.Path(dir32) / f"gso_{step}.out"
        _, s64 = read_state_sidecar(f64)
        _, s32 = read_state_sidecar(f32)
        ds = np.abs(s64["scoring"] - s32["scoring"]).max()
        dt = np.abs(s64["t"] - s32["t"]).max()
        identical = f64.read_text() == f32.read_text()
        if not identical and first_diff is None:
            first_diff = step
        horizon.append({"step": step, "max_dscore": float(ds),
                        "max_dt": float(dt),
                        "rendered_identical": identical})

    _, e64 = read_state_sidecar(pathlib.Path(dir64) / "gso_100.out")
    _, e32 = read_state_sidecar(pathlib.Path(dir32) / "gso_100.out")
    sc64 = np.asarray(e64["scoring"], np.float64)
    sc32 = np.asarray(e32["scoring"], np.float64)
    top64 = set(np.argsort(-sc64)[:10].tolist())
    top32 = set(np.argsort(-sc32)[:10].tolist())

    co64 = pose_coords(sim, e64)
    co32 = pose_coords(sim, e32)
    cl64 = cluster_bsas(co64, sc64)
    cl32 = cluster_bsas(co32, sc32)
    reps64 = set(c.representative for c in cl64)
    reps32 = set(c.representative for c in cl32)

    return {
        "horizon": horizon,
        "first_rendered_divergence_step": first_diff,
        "step100": {
            "best_score_f64": float(sc64.max()),
            "best_score_f32": float(sc32.max()),
            "best_score_rel_diff": float(abs(sc64.max() - sc32.max())
                                         / max(abs(sc64.max()), 1e-9)),
            "best_pose_same": bool(np.argmax(sc64) == np.argmax(sc32)),
            "top10_overlap": len(top64 & top32),
            "kendall_tau": float(kendall_tau(sc64, sc32)),
            "n_clusters_f64": len(cl64),
            "n_clusters_f32": len(cl32),
            "cluster_rep_overlap": len(reps64 & reps32),
        },
    }


def emit_f32(args):
    """Run ONLY the f32 leg on the session backend (the only process that
    opens the GPU), plus part A against the CPU-precomputed f64 oracle
    energies."""
    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    backend = jax.default_backend()
    name = args.examples.split(",")[0]
    sim, method = load_example(name)
    cache = pathlib.Path(args.f64_cache)
    ref = np.load(cache / f"{name}_ref_energies.npy")
    acc = energy_accuracy(sim, method, ref)
    out = pathlib.Path(args.emit_f32)
    log(f"[{name}] f32 {args.engine} run ({backend})")
    run_engine(sim, out, "f32", args.engine)
    (out / "partA.json").write_text(json.dumps(
        {"energy_accuracy": acc, "backend": backend}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["auto", "cpu"], default="auto")
    ap.add_argument("--engine", choices=["xla", "pallas", "auto"],
                    default="auto")
    ap.add_argument("--examples", default="1azp,1ppe")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "precision.json"))
    ap.add_argument("--hybrids", action="store_true",
                    help="also run the f32/f64 mixed state-vs-energy "
                         "isolation experiments (CPU)")
    ap.add_argument("--f64-cache", default=None,
                    help="directory holding (or to hold) the f64 reference "
                         "runs, reused across sessions")
    ap.add_argument("--emit-f32", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.emit_f32:
        emit_f32(args)
        return

    # This process runs CPU + x64 (goldens are an f64 contract) and never
    # opens the GPU; the f32 leg runs in a child on the session backend.
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    log(f"driver on cpu; f32 legs on "
        f"{'cpu' if args.platform == 'cpu' else 'session backend'}")

    cache = pathlib.Path(args.f64_cache or
                         tempfile.mkdtemp(prefix="precision_f64_"))
    cache.mkdir(parents=True, exist_ok=True)
    results = {}
    for name in args.examples.split(","):
        sim, method = load_example(name)

        dir64 = cache / name
        if not (dir64 / "gso_100.out").exists():
            log(f"[{name}] f64 XLA reference run (CPU)")
            run_engine(sim, dir64, "f64", "xla")
        ref_npy = cache / f"{name}_ref_energies.npy"
        if not ref_npy.exists():
            np.save(ref_npy, f64_ref_energies(sim))
        if name == "1azp":
            # Sanity: the f64 leg must byte-match the shipped goldens.
            for step in (1, 10):
                golden = (REFERENCE / "example/1azp/swarm_0"
                          / f"gso_{step}.out").read_text()
                got = (dir64 / f"gso_{step}.out").read_text()
                assert got == golden, f"f64 leg broke the {step} golden"
            log("[1azp] f64 leg byte-matches the shipped goldens (1, 10)")

        with tempfile.TemporaryDirectory() as d32:
            import subprocess
            import sys as _sys
            cmd = [_sys.executable, __file__, "--emit-f32", d32,
                   "--examples", name, "--engine", args.engine,
                   "--f64-cache", str(cache)]
            if args.platform == "cpu":
                cmd += ["--platform", "cpu"]
            rc = subprocess.call(cmd)
            assert rc == 0, f"f32 leg failed rc={rc}"
            part_a = json.loads((pathlib.Path(d32) / "partA.json")
                                .read_text())
            backend = part_a["backend"]
            row = {"example": name, "method": method, "backend": backend,
                   "engine_f32": args.engine,
                   "energy_accuracy": part_a["energy_accuracy"]}
            row.update(compare_runs(dir64, d32, sim))
        results[f"{name}_{backend}_{args.engine}"] = row
        log(f"[{name}] first divergence step: "
            f"{row['first_rendered_divergence_step']}, step100: "
            f"{json.dumps(row['step100'])}")

        if args.hybrids:
            # CONTROL: seed-to-seed variability of the all-f64 engine.
            # GSO is a stochastic optimizer; if f32-vs-f64 metrics fall
            # inside the f64 seed-vs-seed spread, the f32 path is "as
            # equivalent as a different random seed" — the strongest
            # result-level statement a chaotic optimizer admits.
            dirB = cache / f"{name}_seedB"
            if not (dirB / "gso_100.out").exists():
                log(f"[{name}] f64 control run, seed+1 (CPU)")
                run_engine(sim, dirB, "f64", "xla", seed=sim.seed + 1)
            ctrl = compare_runs(dir64, dirB, sim)
            results[f"{name}_control_f64_seedB"] = {
                "example": name, "note": "f64 seed=S vs f64 seed=S+1 - "
                "the optimizer's own run-to-run spread", **ctrl}
            log(f"[{name}] f64 seed control: "
                f"tau={ctrl['step100']['kendall_tau']:.3f}, "
                f"best_rel={ctrl['step100']['best_score_rel_diff']:.4f}")

            # Which precision term BINDS the f32 horizon?  Two hybrid
            # runs isolate it: f32 state + f64 scoring (state rounding
            # only) vs f64 state + f32 scoring (energy rounding only).
            # CPU-only: this process never opens the GPU.
            for label, sd, ed in (("f32_state_f64_energy", "f32", "f64"),
                                  ("f64_state_f32_energy", "f64", "f32")):
                with tempfile.TemporaryDirectory() as dh:
                    log(f"[{name}] hybrid {label} (xla, cpu)")
                    run_engine(sim, dh, sd, "xla", energy_dtype=ed)
                    hrow = compare_runs(dir64, dh, sim)
                results[f"{name}_hybrid_{label}"] = {
                    "example": name, "state_dtype": sd, "energy_dtype": ed,
                    "engine": "xla", "backend": "cpu", **hrow}
                log(f"[{name}] {label}: first divergence "
                    f"{hrow['first_rendered_divergence_step']}, "
                    f"tau={hrow['step100']['kendall_tau']:.3f}")

    out = pathlib.Path(args.out)
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged.update(results)
    out.write_text(json.dumps(merged, indent=2) + "\n")
    log(f"-> {out}")


if __name__ == "__main__":
    main()
