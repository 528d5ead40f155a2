#!/usr/bin/env python3
"""Where a CLI run's time goes, on the GPU, one process.

For each shape, the pieces of ``lightdock-tpu``'s single-swarm path
(cli.run_jax) timed on their own, with one GsoJaxRunner reused:

  params       scoring params built on the host (sim.batch_params)
  runner_init  GsoJaxRunner construction: spatial sort, upload, jit setup
  first        first run_segmented with snapshots (compilation included)
  warm_snap    the same run again (the runner rewound), snapshots on
  warm_nosnap  again with snapshots off: device time plus dispatch
  host_rng     the bit-exact host random stream for the whole run

The difference warm_snap - warm_nosnap is the snapshot output (device to
host copies, text and sidecar writes every 10 steps).

    python scripts/bench_cli_breakdown.py [--shapes 1ppe:100,1azp:100,1k4c:10]
        [--out chiprun_out/cli_breakdown.json]
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


def breakdown(sim, steps, outdir):
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.cli import energy_budget_bytes, pick_energy_chunk
    from lightdock_tpu.engine.gso_jax import GsoJaxRunner
    from lightdock_tpu.utils.rng import uniform_f64_stream

    g = sim.positions.shape[0]
    row = {}
    t0 = time.perf_counter()
    params = sim.batch_params(dtype=np.float32)
    row["params_s"] = time.perf_counter() - t0
    chunk = pick_energy_chunk(sim.receptor.num_atoms * sim.ligand.num_atoms,
                              g, 4, energy_budget_bytes())
    t0 = time.perf_counter()
    runner = GsoJaxRunner(params, sim.positions, sim.seed, sim.use_anm,
                          sim.setup.anm_rec, sim.setup.anm_lig,
                          output_directory=str(outdir), dtype=jnp.float32,
                          energy_chunk=chunk, energy_mode="auto")
    jax.block_until_ready(runner.params)
    row["runner_init_s"] = time.perf_counter() - t0
    row["energy_mode"] = runner.energy_mode

    def run():
        runner.reset()
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(steps, 10)
        jax.block_until_ready(final)
        return time.perf_counter() - t0

    row["first_s"] = run()
    row["warm_snap_s"] = run()
    runner.output_directory = None
    row["warm_nosnap_s"] = run()
    t0 = time.perf_counter()
    uniform_f64_stream(sim.seed, steps * g)
    row["host_rng_s"] = time.perf_counter() - t0
    row["snapshot_share"] = ((row["warm_snap_s"] - row["warm_nosnap_s"])
                             / row["warm_snap_s"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="1ppe:100,1azp:100,1k4c:10",
                    help="comma-separated NAME:STEPS")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from lightdock_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    from lightdock_tpu import synthetic
    from lightdock_tpu.utils.device_info import nvidia_smi_line, require_gpu

    dev = require_gpu()
    card = nvidia_smi_line()
    print(f"device: {dev}  card: {card}  jax {jax.__version__}", flush=True)
    results = {"device": dev, "card": card, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for item in args.shapes.split(","):
            name, steps = item.split(":")
            work = pathlib.Path(tmp) / name
            sim = synthetic.load(synthetic.make_complex(name, work, swarms=1))
            row = breakdown(sim, int(steps), work / "swarm_0")
            results["shapes"][item] = row
            print(f"{item} ({row['energy_mode']}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()
                if isinstance(v, float)), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
