"""Command-line driver, argv-compatible with the reference binary.

Usage (reference src/bin/lightdock-rust.rs:92-147):

    lightdock-tpu <setup.json> <initial_positions_N.dat> <steps> <dfire|dna|pydock>

plus optional flags selecting the engine and precision.  Outputs are
written to ``./swarm_N/gso_{step}.out`` (created when missing, reference
bin:174-185); ANM ``.npy`` files are read from the working directory
(reference bin:217-254).
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lightdock-tpu",
        description="GSO docking on JAX (DFIRE / DNA / PYDOCK scoring)")
    ap.add_argument("setup", help="setup.json produced by lightdock3_setup.py")
    ap.add_argument("positions", help="initial_positions_N.dat")
    ap.add_argument("steps", type=int, help="number of GSO steps")
    ap.add_argument("method", type=str.lower, choices=["dfire", "dna", "pydock"])
    ap.add_argument("--engine", choices=["jax", "host"], default="jax",
                    help="jax: batched device engine (default); "
                         "host: float64 NumPy parity engine")
    ap.add_argument("--platform", choices=["auto", "cpu", "gpu"], default="auto",
                    help="require a JAX platform; fails when it is not the "
                         "one JAX runs on (default: whatever JAX picks)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="device compute precision (default: float64 on CPU, "
                         "float32 on accelerators)")
    ap.add_argument("--energy-chunk", type=int, default=None,
                    help="glowworm-axis chunk for pair-energy evaluation "
                         "(default: auto from pair count)")
    ap.add_argument("--anm-dir", default=None,
                    help="directory holding rec_nm.npy/lig_nm.npy "
                         "(default: working directory, like the reference)")
    ap.add_argument("--output-dir", default=None,
                    help="override output directory (default: ./swarm_N)")
    ap.add_argument("--steps-per-save", type=int, default=10)
    ap.add_argument("--energy-mode", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="pair-energy backend: fused XLA, the DFIRE pair "
                         "kernel with spatial tile culling (GPU only), or "
                         "auto (the kernel where it measured faster)")
    ap.add_argument("--jax-rng", action="store_true",
                    help="use the native device RNG instead of the bit-exact "
                         "reference (rand 0.7) stream")
    ap.add_argument("--profile", action="store_true",
                    help="capture a jax.profiler trace of the run")
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write JSON-lines run metrics to FILE")
    ap.add_argument("--resume", metavar="GSO_OUT",
                    help="resume from a previous gso_N.out snapshot; in "
                         "multi-swarm mode pass 'auto' to continue every "
                         "swarm from its newest sidecar checkpoint")
    ap.add_argument("--resume-step", type=int, default=0,
                    help="step number the snapshot corresponds to")
    return ap


# Pair-intermediate budget on hosts whose device reports no memory limit
# (the CPU backend).
HOST_ENERGY_BUDGET = 1.5e9
# Share of the device's memory limit given to pair intermediates.
DEVICE_ENERGY_SHARE = 0.25


def energy_budget_bytes() -> int:
    """Bytes the (chunk, Nr, Nl) pair intermediates may take: a share of
    the device's own ``bytes_limit``, or a fixed budget on the CPU."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"] * DEVICE_ENERGY_SHARE)
    return int(HOST_ENERGY_BUDGET)


def pick_energy_chunk(n_pairs: int, g: int, dtype_bytes: int,
                      budget_bytes: int = HOST_ENERGY_BUDGET) -> int:
    """Bound the (chunk, Nr, Nl) working set to ``budget_bytes`` of
    intermediates.

    Rounds to an even partition of the glowworm axis so padding waste is
    minimal.
    """
    per_pose = 6 * dtype_bytes * max(n_pairs, 1)  # ~6 live pair-sized arrays
    chunk = max(1, int(budget_bytes) // per_pose)
    if chunk >= g:
        return 0  # no chunking needed
    n_seg = -(-g // chunk)
    return -(-g // n_seg)


def main(argv=None) -> int:
    from .utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("LIGHTDOCK_TPU_LOG", "INFO"),
        format="%(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("lightdock_tpu")

    from .simulation import load_simulation
    from .utils.positions import parse_swarm_id

    # Multi-swarm mode: a glob or comma-separated list of positions files
    # runs all swarms batched in one device program (the built-in
    # replacement for the reference's external process farm).
    import glob as _glob
    multi = ([p for part in args.positions.split(",") for p in sorted(_glob.glob(part))]
             if ("," in args.positions or any(c in args.positions for c in "*?["))
             else None)
    if multi and len(multi) >= 1:
        return run_multi(args, multi, log)

    print(f"Reading starting positions from {args.positions!r}")
    swarm_id = parse_swarm_id(args.positions)
    print(f"Swarm ID {swarm_id}")
    outdir = pathlib.Path(args.output_dir or f"swarm_{swarm_id}")
    if not outdir.is_dir():
        print(f"Output directory does not exist for swarm {swarm_id}, creating it",
              file=sys.stderr)
        outdir.mkdir(parents=True, exist_ok=True)
    print(f"Writing to swarm dir {str(outdir)!r}")

    print(f"Loading {args.method.upper()} scoring function")
    sim = load_simulation(args.setup, args.positions, args.method,
                          anm_dir=args.anm_dir)
    print(f"Creating GSO with {sim.positions.shape[0]} glowworms")

    start = time.time()
    if args.engine == "host":
        run_host(sim, args, outdir)
    else:
        run_jax(sim, args, outdir, log)
    print(f"Done ({args.steps} steps) in {time.time() - start:.2f}s")
    return 0


def run_multi(args, positions_files, log) -> int:
    """Batched multi-swarm execution: all swarms in one jitted program,
    sharded over the available devices."""
    import jax

    from .parallel.farm import run_swarm_farm
    from .parallel.multihost import maybe_initialize_distributed
    from .simulation import load_simulation
    from .utils.positions import parse_positions, parse_swarm_id

    _apply_platform(args)
    maybe_initialize_distributed()
    backend = jax.default_backend()
    dtype_name = args.dtype or ("float64" if backend == "cpu" else "float32")
    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = jnp.float64 if dtype_name == "float64" else jnp.float32

    sim = load_simulation(args.setup, positions_files[0], args.method,
                          anm_dir=args.anm_dir)
    swarm_ids = [parse_swarm_id(p) for p in positions_files]
    positions_list = [parse_positions(p) for p in positions_files]
    print(f"Running {len(positions_list)} swarms x "
          f"{positions_list[0].shape[0]} glowworms on {len(jax.devices())} "
          f"device(s) [{backend}]")

    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    g = positions_list[0].shape[0]
    chunk = (args.energy_chunk if args.energy_chunk is not None
             else pick_energy_chunk(n_pairs, g * len(positions_list),
                                    np.dtype(dtype_name).itemsize,
                                    energy_budget_bytes()))
    log.info("backend=%s dtype=%s energy_chunk=%s pairs=%d",
             backend, dtype_name, chunk, n_pairs)

    from .utils.metrics import RunMetrics
    metrics = RunMetrics(args.metrics, context={
        "backend": backend, "dtype": dtype_name, "method": sim.method,
        "pairs": n_pairs, "glowworms": g, "swarms": len(positions_list)})
    output_root = args.output_dir or "."

    import time
    t0 = time.time()

    params = sim.batch_params(dtype=np.dtype(dtype_name))

    def farm():
        run_swarm_farm(params, positions_list, swarm_ids, sim.seed,
                       args.steps, sim.use_anm, sim.setup.anm_rec,
                       sim.setup.anm_lig, dtype, output_root=output_root,
                       energy_chunk=chunk, energy_mode=args.energy_mode,
                       segment=max(1, args.steps_per_save),
                       metrics=metrics, resume=bool(args.resume))

    if args.profile:
        import pathlib as _pl
        trace_dir = _pl.Path(output_root) / "jax_trace"
        with jax.profiler.trace(str(trace_dir)):
            farm()
        log.info("profiler trace written to %s", trace_dir)
    else:
        farm()
    summary = metrics.summary()
    metrics.close()
    dt = time.time() - t0
    total_poses = len(positions_list) * g * args.steps
    print(f"Done: {len(positions_list)} swarms x {args.steps} steps in "
          f"{dt:.2f}s ({total_poses / dt:.0f} poses/s aggregate)")
    if summary["poses_per_s"]:
        print(f"Throughput: {summary['poses_per_s']} poses/s")
    return 0


def run_host(sim, args, outdir) -> None:
    from .engine.gso_host import GsoHostEngine

    engine = GsoHostEngine(sim.batch_params(), sim.positions, sim.seed,
                           sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                           output_directory=str(outdir))
    print(f"Starting optimization ({args.steps} steps)")
    engine.run(args.steps)


def _apply_platform(args) -> None:
    """Honour --platform: select it, then fail loudly unless JAX runs on it
    (no silent fallback to another device)."""
    platform = getattr(args, "platform", "auto")
    if platform == "auto":
        return
    import jax

    jax.config.update("jax_platforms", "cuda" if platform == "gpu" else platform)
    try:
        backend = jax.default_backend()
    except (AssertionError, RuntimeError) as err:
        raise RuntimeError(f"--platform {platform}: JAX cannot start it "
                           f"({err!r})") from err
    if backend != platform:
        raise RuntimeError(f"--platform {platform} requested but JAX runs on "
                           f"{backend!r}")


def run_jax(sim, args, outdir, log) -> None:
    import jax

    _apply_platform(args)
    backend = jax.default_backend()
    dtype_name = args.dtype or ("float64" if backend == "cpu" else "float32")
    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = jnp.float64 if dtype_name == "float64" else jnp.float32

    from .engine.gso_jax import GsoJaxRunner

    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    g = sim.positions.shape[0]
    chunk = (args.energy_chunk if args.energy_chunk is not None
             else pick_energy_chunk(n_pairs, g, np.dtype(dtype_name).itemsize,
                                    energy_budget_bytes()))
    log.info("backend=%s dtype=%s energy_chunk=%s pairs=%d",
             backend, dtype_name, chunk, n_pairs)

    runner = GsoJaxRunner(sim.batch_params(dtype=np.dtype(dtype_name)),
                          sim.positions, sim.seed, sim.use_anm,
                          sim.setup.anm_rec, sim.setup.anm_lig,
                          output_directory=str(outdir), dtype=dtype,
                          energy_chunk=chunk, energy_mode=args.energy_mode,
                          rng_mode="native" if args.jax_rng else "reference")
    log.info("energy_mode=%s", runner.energy_mode)
    if args.resume:
        runner.load_snapshot(args.resume, args.resume_step)
    print(f"Starting optimization ({args.steps} steps)")
    segment = max(1, args.steps_per_save)
    from .utils.metrics import RunMetrics
    metrics = RunMetrics(args.metrics, context={
        "backend": backend, "dtype": dtype_name, "method": sim.method,
        "pairs": n_pairs, "glowworms": g})
    if args.profile:
        with jax.profiler.trace(str(outdir / "jax_trace")):
            runner.run_segmented(args.steps, segment, metrics=metrics)
        log.info("profiler trace written to %s", outdir / "jax_trace")
    else:
        runner.run_segmented(args.steps, segment, metrics=metrics)
    summary = metrics.summary()
    metrics.close()
    if summary["poses_per_s"]:
        print(f"Throughput: {summary['poses_per_s']} poses/s")


if __name__ == "__main__":
    sys.exit(main())
