#!/usr/bin/env python3
"""Compare the DFIRE device forms end to end on the GPU.

For each complex shape and each pose set, 200-glowworm GsoJaxRunner runs
(snapshots off) with the pair energy as
  xla-gather  the flat-table gather (energy_batch._dfire_parts)
  kernel      the culled DFIRE pair kernel (ops.pallas_energy)
taking turns between forms, warm-up counted as set-up.  Pose sets:
``setup`` starts from the poses ``lightdock-tpu-tools setup`` places
(clear of the receptor), ``contact`` from the same poses pulled toward the
receptor centre (synthetic.contact_positions), where the kernel's tile
cull skips least.  Prints the median and spread per form, and each form's
final energies against the f64 oracle.

``--blocks`` adds a sweep of the kernel's (receptor, ligand) block sizes:
one 100-step scan per block shape, same turns and repeats.

A shape is a name of synthetic.SHAPES or ``NRxNL`` (a rigid DFIRE complex
of NR x NL atoms).  One process drives the card.

    python scripts/bench_dfire_forms.py [--shapes 1ppe,2uuy,1k4c]
        [--poses setup,contact] [--steps 100] [--repeats 5]
        [--blocks 32x32,64x64,128x64] [--out chiprun_out/dfire_forms.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

FORMS = ("xla-gather", "kernel")


def shape_of(name):
    from lightdock_tpu import synthetic

    if name in synthetic.SHAPES:
        return synthetic.SHAPES[name]
    nr, nl = (int(x) for x in name.split("x"))
    return synthetic.ComplexShape(name, nr, nl, "dfire")


def build_runners(sim, positions, budget):
    import jax.numpy as jnp

    from lightdock_tpu.cli import pick_energy_chunk
    from lightdock_tpu.engine.gso_jax import GsoJaxRunner

    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    chunk = pick_energy_chunk(n_pairs, positions.shape[0], 4, budget)
    kw = dict(positions=positions, seed=sim.seed, use_anm=sim.use_anm,
              anm_rec=sim.setup.anm_rec, anm_lig=sim.setup.anm_lig,
              dtype=jnp.float32)
    params = sim.batch_params(dtype=np.float32)
    return chunk, {
        "xla-gather": GsoJaxRunner(params, energy_chunk=chunk, **kw),
        "kernel": GsoJaxRunner(params, energy_mode="pallas", **kw),
    }


def timed_run(runner, steps):
    import jax

    runner.reset()
    t0 = time.perf_counter()
    final, _ = runner.run_segmented(steps, 10)
    jax.block_until_ready(final)
    return time.perf_counter() - t0


def block_run(sim, positions, steps, r_blk, l_blk):
    """A zero-argument callable running ``steps`` GSO steps with the kernel
    at the given block sizes (one compiled scan)."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.engine.energy_pallas import (make_pallas_energy_fn,
                                                    spatial_sort_params)
    from lightdock_tpu.engine.gso_jax import device_params, init_state, run_swarm
    from lightdock_tpu.utils.rng import uniform_f64_stream

    srt = spatial_sort_params(sim.batch_params(dtype=np.float32), r_blk, l_blk)
    fn = make_pallas_energy_fn(srt, r_blk=r_blk, l_blk=l_blk)
    p = device_params(srt, np.float32)
    state = init_state(positions, sim.use_anm, sim.setup.anm_rec,
                       sim.setup.anm_lig, jnp.float32)
    g = positions.shape[0]
    rnd = jnp.asarray(uniform_f64_stream(sim.seed, steps * g).reshape(steps, g),
                      jnp.float32)
    run = jax.jit(lambda p_, s, r: run_swarm(p_, s, r, energy_fn=fn))

    def go():
        t0 = time.perf_counter()
        jax.block_until_ready(run(p, state, rnd))
        return time.perf_counter() - t0

    return go


def oracle_error(sim, runner, n_poses=16):
    """Max |E_device - E_f64| / max(1, |E_f64|) over the first n final poses,
    scored by the runner's own energy path."""
    import jax

    st = runner.state
    sl = lambda x: x[:n_poses]  # noqa: E731
    dev = np.asarray(jax.jit(runner.energy_fn)(runner.params, sl(st.t), sl(st.q),
                                 sl(st.a_rec), sl(st.a_lig)), np.float64)
    hs = sim.host_scorer()
    ref = np.array([hs.energy(*(np.asarray(x[i], np.float64) for x in
                                (st.t, st.q, st.a_rec, st.a_lig)))
                    for i in range(n_poses)])
    return float(np.max(np.abs(dev - ref) / np.maximum(1.0, np.abs(ref))))


def summarize(runs, g, steps):
    runs = np.asarray(runs)
    med = float(np.median(runs))
    return {"runs_s": runs.tolist(), "median_s": med,
            "min_s": float(runs.min()), "max_s": float(runs.max()),
            "poses_per_s": g * steps / med}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="1ppe,2uuy,1k4c")
    ap.add_argument("--poses", default="setup,contact")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--blocks", default="",
                    help="kernel block sweep, e.g. 32x32,64x64,128x64")
    ap.add_argument("--block-shapes", default="1ppe,1k4c",
                    help="shapes the block sweep runs on (contact poses)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from lightdock_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    from lightdock_tpu import synthetic
    from lightdock_tpu.cli import energy_budget_bytes
    from lightdock_tpu.utils.device_info import nvidia_smi_line, require_gpu

    dev = require_gpu()
    card = nvidia_smi_line()
    print(f"device: {dev}  card: {card}  jax {jax.__version__}", flush=True)
    results = {"device": dev, "card": card, "steps": args.steps,
               "repeats": args.repeats, "shapes": {}, "blocks": {}}
    sims = {}
    for name in dict.fromkeys(args.shapes.split(",")
                              + (args.block_shapes.split(",") if args.blocks else [])):
        with tempfile.TemporaryDirectory() as tmp:
            sims[name] = synthetic.load(
                synthetic.make_complex(shape_of(name), tmp, swarms=1))
    for name in args.shapes.split(","):
        sim = sims[name]
        for poses in args.poses.split(","):
            positions = (synthetic.contact_positions(sim) if poses == "contact"
                         else sim.positions)
            chunk, runners = build_runners(sim, positions, energy_budget_bytes())
            g = positions.shape[0]
            row = {"atoms": [sim.receptor.num_atoms, sim.ligand.num_atoms],
                   "energy_chunk": chunk, "forms": {}}
            first = {f: timed_run(runners[f], args.steps) for f in FORMS}
            runs = {f: [] for f in FORMS}
            for _ in range(args.repeats):
                for form in FORMS:
                    runs[form].append(timed_run(runners[form], args.steps))
            for form in FORMS:
                r = row["forms"][form] = summarize(runs[form], g, args.steps)
                r["first_run_s"] = first[form]
                r["oracle_max_rel_err"] = oracle_error(sim, runners[form])
                print(f"{name} {poses} {form}: median {r['median_s']:.4f}s "
                      f"[{r['min_s']:.4f}, {r['max_s']:.4f}] "
                      f"{r['poses_per_s']:.0f} poses/s; oracle max rel err "
                      f"{r['oracle_max_rel_err']:.2e}", flush=True)
            stats = jax.devices()[0].memory_stats() or {}
            row["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
            results["shapes"][f"{name}/{poses}"] = row
            del runners
    if args.blocks:
        blocks = [tuple(int(x) for x in b.split("x"))
                  for b in args.blocks.split(",")]
        for name in args.block_shapes.split(","):
            sim = sims[name]
            positions = synthetic.contact_positions(sim)
            fns = {b: block_run(sim, positions, args.steps, *b) for b in blocks}
            for fn in fns.values():
                fn()  # compile + warm-up
            runs = {b: [] for b in blocks}
            for _ in range(args.repeats):
                for b in blocks:
                    runs[b].append(fns[b]())
            row = {}
            for b in blocks:
                row[f"{b[0]}x{b[1]}"] = s = summarize(runs[b],
                                                      positions.shape[0],
                                                      args.steps)
                print(f"blocks {name} contact {b[0]}x{b[1]}: median "
                      f"{s['median_s']:.4f}s [{s['min_s']:.4f}, "
                      f"{s['max_s']:.4f}]", flush=True)
            results["blocks"][name] = row
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({k: {f: round(v["forms"][f]["median_s"], 5)
                          for f in v["forms"]}
                      for k, v in results["shapes"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
