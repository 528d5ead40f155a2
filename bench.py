#!/usr/bin/env python3
"""North-star benchmark: poses scored/sec on one GPU, 1ppe-shaped DFIRE.

Runs the batched device engine for 100 GSO steps, 200 glowworms, on a
seeded synthetic complex at the 1ppe example's atom counts (1615 x 221
atoms, no ANM; lightdock_tpu.synthetic) — the reference's headline
configuration (BASELINE.md: 4.252 s wall-clock, ~4.7k poses/s upper bound
on one M3 CPU core) — then a 32-swarm farm, and prints ONE JSON line:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "device": {...}, "card": ...}

Diagnostics go to stderr.  Fails unless JAX runs on a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_POSES_PER_S = 4700.0  # reference upper bound, BASELINE.md (1ppe)
STEPS = 100


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(runner, steps, segment):
    import jax

    runner.reset()
    t0 = time.perf_counter()
    final, _ = runner.run_segmented(steps, segment)
    jax.block_until_ready(final)
    return time.perf_counter() - t0


def main() -> int:
    from lightdock_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from lightdock_tpu import synthetic
    from lightdock_tpu.engine.gso_jax import GsoJaxRunner
    from lightdock_tpu.utils.device_info import nvidia_smi_line, require_gpu

    device = require_gpu()
    card = nvidia_smi_line()
    log(f"device={device} card={card}")

    with tempfile.TemporaryDirectory() as tmp:
        sim = synthetic.load(synthetic.make_complex("1ppe", tmp))
    params = sim.batch_params(dtype=np.float32)
    positions = sim.positions
    g = positions.shape[0]
    n_pairs = params.rec_coords.shape[0] * params.lig_coords.shape[0]
    mode = os.environ.get("LIGHTDOCK_BENCH_MODE", "auto")

    runner = GsoJaxRunner(params, positions, seed=sim.seed, use_anm=False,
                          anm_rec=0, anm_lig=0, dtype=jnp.float32,
                          energy_mode=mode)
    log(f"compile+first run: {timed(runner, STEPS, 10):.2f}s")
    times = [timed(runner, STEPS, 10) for _ in range(5)]
    med = float(np.median(times))
    poses_per_s = g * STEPS / med
    log(f"100-step wall-clock: median {med:.4f}s "
        f"(runs: {['%.4f' % t for t in times]})")
    log(f"pair-interactions/s: {g * STEPS * n_pairs / med:.3e}")

    if os.environ.get("LIGHTDOCK_BENCH_MULTISWARM", "1") != "0":
        aggregate_multiswarm(params, positions, g, sim.seed, mode)

    print(json.dumps({
        "metric": "poses_scored_per_sec_per_gpu_1ppe_dfire",
        "value": round(poses_per_s, 1),
        "unit": "poses/s",
        "vs_baseline": round(poses_per_s / BASELINE_POSES_PER_S, 2),
        "device": device,
        "card": card,
    }))
    return 0


def aggregate_multiswarm(params, positions, g, seed, mode,
                         n_swarms: int = 32, steps: int = 50):
    """Throughput with several swarms batched per device (and sharded over
    the swarm mesh axis on several devices), through the production farm."""
    import jax
    import jax.numpy as jnp

    from lightdock_tpu.parallel.farm import SwarmFarmRunner

    n_dev = len(jax.devices())
    s = max(n_swarms, n_dev)
    runner = SwarmFarmRunner(params, [positions] * s, list(range(s)),
                             seed=seed, use_anm=False, anm_rec=0, anm_lig=0,
                             dtype=jnp.float32, output_root=None,
                             energy_mode=mode)
    timed_farm = lambda: timed(runner, steps, steps)  # noqa: E731
    timed_farm()  # compile + warm-up
    dt = timed_farm()
    agg = s * g * steps / dt
    log(f"multi-swarm aggregate: {s} swarms x {steps} steps on {n_dev} "
        f"device(s): {agg:.0f} poses/s total ({agg / s:.0f} per swarm)")


if __name__ == "__main__":
    sys.exit(main())
