#!/usr/bin/env python3
"""Per-example bench table: all five reference workloads.

Measures poses scored/s (single swarm, 200 glowworms, production f32
device path, energy_mode=auto) for every example the reference README
publishes a wall-clock for (reference README.md:27-148), with the device
and vs_baseline per row, into chiprun_out/examples.json.  Needs the
reference examples (LIGHTDOCK_REFERENCE).

One example per child process; the parent never imports JAX, so only the
child opens the GPU:

  python scripts/bench_examples.py 1ppe          # one example, merge row
  python scripts/bench_examples.py --all         # subprocess per example
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REFERENCE = pathlib.Path(os.environ.get("LIGHTDOCK_REFERENCE",
                                        "/root/reference"))
OUT = ROOT / "chiprun_out" / "examples.json"

# name -> (method, reference wall-clock seconds for 200x100, steps)
EXAMPLES = {
    "1ppe": ("dfire", 4.252, 100),
    "2uuy": ("dfire", 8.108, 100),
    "1czy": ("dfire", 1.580, 100),
    "1azp": ("dna", 14.228, 100),
    "1k4c": ("dfire", 112.132, 10),  # 11.15M pairs: 10-step segments
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_one(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.engine.gso_jax import GsoJaxRunner, pick_energy_mode
    from lightdock_tpu.simulation import load_simulation

    method, ref_wall, steps = EXAMPLES[name]
    ex = REFERENCE / "example" / name
    pos = ex / "initial_positions_0.dat"
    if not pos.exists():
        pos = ex / "init" / "initial_positions_0.dat"
    sim = load_simulation(ex / "setup.json", pos, method, anm_dir=ex)
    g = sim.positions.shape[0]
    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    params = sim.batch_params(dtype=np.float32)
    mode = pick_energy_mode(params)
    log(f"[{name}] {sim.receptor.num_atoms}x{sim.ligand.num_atoms} = "
        f"{n_pairs:,} pairs, anm={sim.use_anm}, mode={mode}, "
        f"backend={jax.default_backend()}")
    runner = GsoJaxRunner(params, sim.positions, sim.seed, sim.use_anm,
                          sim.setup.anm_rec, sim.setup.anm_lig,
                          dtype=jnp.float32, energy_mode=mode)

    def once():
        runner.reset()
        t0 = time.perf_counter()
        final, _ = runner.run_segmented(steps, 10)
        jax.block_until_ready(final)
        return time.perf_counter() - t0

    compile_s = once()
    best = min(once() for _ in range(3))
    poses_s = g * steps / best
    baseline = 200 * 100 / ref_wall
    row = {
        "atoms": [sim.receptor.num_atoms, sim.ligand.num_atoms],
        "pairs": n_pairs,
        "anm": bool(sim.use_anm),
        "method": method,
        "energy_mode": mode,
        "steps": steps,
        "wall_s": round(best, 4),
        "compile_s": round(compile_s, 1),
        "poses_per_s": round(poses_s, 1),
        "baseline_poses_per_s": round(baseline, 1),
        "vs_baseline": round(poses_s / baseline, 2),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    log(f"[{name}] {poses_s:,.0f} poses/s = {row['vs_baseline']}x baseline "
        f"(compile {compile_s:.0f}s)")
    return row


def merge_row(name: str, row: dict) -> None:
    data = json.loads(OUT.read_text()) if OUT.exists() else {
        "note": "single swarm, 200 glowworms, f32 production path, "
                "energy_mode=auto, min-of-3 wall-clock; baselines from "
                "/root/reference/README.md:27-148 (M3 Pro, 1 thread)"}
    data[name] = row
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(data, indent=2) + "\n")


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--all":
        rc_all = 0
        for name in EXAMPLES:
            log(f"=== {name} ===")
            rc = subprocess.call([sys.executable, __file__, name])
            if rc != 0:
                log(f"[{name}] FAILED rc={rc}")
                rc_all = rc
        print(OUT.read_text() if OUT.exists() else "{}")
        return rc_all

    name = args[0] if args else "1ppe"
    from lightdock_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    row = bench_one(name)
    merge_row(name, row)
    print(json.dumps({name: row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
