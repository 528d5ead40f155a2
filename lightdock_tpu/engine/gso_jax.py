"""Batched GSO device engine (JAX): the optimizer core.

The reference iterates 200 glowworm objects sequentially (reference
src/swarm.rs:66-126); here the swarm is a struct-of-arrays pytree with a
leading glowworm axis and one optimization step is a single traced
function: batched energies -> luciferin update -> (G, G) neighbor search ->
vectorised roulette selection -> batched slerp/translation/ANM moves ->
vision update.  The full run is ``jax.lax.scan`` over steps, jitted once.

Semantics notes (all mirror the reference exactly):
- Unmoved glowworms keep their score (reference src/glowworm.rs:61-69);
  recomputing them on device yields bit-identical values because the
  computation is deterministic, so the XLA path simply scores all G every
  step (uniform work); the kernel path uses the gate to skip them.
- Moves use the *pre-move* snapshot of all poses (src/swarm.rs:74-83).
- Roulette selection reproduces the strict `sum < r` crossing rule
  (src/glowworm.rs:114-126) via a masked cumulative sum.
- The uniform stream (one f64 per glowworm per step, id order,
  src/swarm.rs:118) is precomputed host-side by the bit-exact rand-0.7
  port and passed in as a (steps, G) array, so device trajectories are
  comparable with the reference / host engine run-for-run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..ops import quaternion as qt
from .energy_batch import BatchScoringParams, batch_energy

# -- pytree registration of the scoring params ------------------------------

_STATIC_FIELDS = ("method", "use_anm", "rec_num_membrane")
_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(BatchScoringParams)
    if f.name not in _STATIC_FIELDS
)


def _params_flatten(p: BatchScoringParams):
    children = tuple(getattr(p, name) for name in _ARRAY_FIELDS)
    aux = tuple(getattr(p, name) for name in _STATIC_FIELDS)
    return children, aux


def _params_unflatten(aux, children):
    kwargs = dict(zip(_ARRAY_FIELDS, children))
    kwargs.update(dict(zip(_STATIC_FIELDS, aux)))
    return BatchScoringParams(**kwargs)


jax.tree_util.register_pytree_node(
    BatchScoringParams, _params_flatten, _params_unflatten)


def device_params(p: BatchScoringParams, dtype=None) -> BatchScoringParams:
    """Copy params with array leaves as device arrays of ``dtype``."""
    def conv(x):
        if x is None:
            return None
        x = np.asarray(x)
        if dtype is not None and np.issubdtype(x.dtype, np.floating):
            x = x.astype(dtype)
        return jnp.asarray(x)

    children, aux = _params_flatten(p)
    return _params_unflatten(aux, tuple(conv(c) for c in children))


# -- state ------------------------------------------------------------------


class SwarmState(NamedTuple):
    """All mutable per-glowworm state, leading axis G (mirrors the fields
    of reference src/glowworm.rs:6-26 minus the constants)."""

    t: jnp.ndarray          # (G, 3) translations
    q: jnp.ndarray          # (G, 4) rotations (w, x, y, z)
    a_rec: jnp.ndarray      # (G, Ka_r) receptor ANM coefficients
    a_lig: jnp.ndarray      # (G, Ka_l) ligand ANM coefficients
    luciferin: jnp.ndarray  # (G,)
    vision: jnp.ndarray     # (G,)
    scoring: jnp.ndarray    # (G,)
    num_neighbors: jnp.ndarray  # (G,) int32


class StepOutput(NamedTuple):
    """Per-step observables emitted by the scan (for snapshots/metrics)."""

    t: jnp.ndarray
    q: jnp.ndarray
    a_rec: jnp.ndarray
    a_lig: jnp.ndarray
    luciferin: jnp.ndarray
    vision: jnp.ndarray
    scoring: jnp.ndarray
    num_neighbors: jnp.ndarray


def init_state(positions: np.ndarray, use_anm: bool, anm_rec: int, anm_lig: int,
               dtype=jnp.float32) -> SwarmState:
    from ..utils.positions import split_positions

    t, q, ar, al = split_positions(np.asarray(positions, dtype=np.float64),
                                   use_anm, anm_rec, anm_lig)
    g = t.shape[0]
    return SwarmState(
        t=jnp.asarray(t, dtype=dtype),
        q=jnp.asarray(q, dtype=dtype),
        a_rec=jnp.asarray(ar, dtype=dtype),
        a_lig=jnp.asarray(al, dtype=dtype),
        luciferin=jnp.full((g,), C.GSO_INITIAL_LUCIFERIN, dtype=dtype),
        vision=jnp.full((g,), C.GSO_INITIAL_VISION_RANGE, dtype=dtype),
        scoring=jnp.zeros((g,), dtype=dtype),
        # 1, not 0: num_neighbors>0 doubles as the "moved last phase"
        # rescoring gate (gso_step) and every pose must score on step one
        # (the reference's step==0 branch, src/glowworm.rs:62).  Resumed
        # states carry their real neighbor counts instead.
        num_neighbors=jnp.ones((g,), dtype=jnp.int32),
    )


# -- energy with G-chunking -------------------------------------------------


def batch_energy_chunked(params: BatchScoringParams, t, q, a_rec, a_lig,
                         chunk: int = 0, moved=None, prev_scoring=None):
    """Scores for G poses; ``chunk`` > 0 processes the glowworm axis in
    chunks under lax.map to bound the (chunk, Nr, Nl) working set.

    ``moved``/``prev_scoring`` (the reference's moved||step==0 rescoring
    gate, src/glowworm.rs:61-72) are accepted for interface compatibility
    and ignored: on the dense XLA path uniform recomputation is free-by
    -construction (a recomputed score of an unmoved pose is bit-identical
    to the stored one), while the kernel path uses them to skip work.
    """
    g = t.shape[0]
    if chunk <= 0 or chunk >= g:
        return batch_energy(params, t, q, a_rec, a_lig, xp=jnp)
    pad = (-g) % chunk
    if pad:
        t = jnp.concatenate([t, t[:pad]], axis=0)
        q = jnp.concatenate([q, q[:pad]], axis=0)
        a_rec = jnp.concatenate([a_rec, a_rec[:pad]], axis=0)
        a_lig = jnp.concatenate([a_lig, a_lig[:pad]], axis=0)
    n = t.shape[0] // chunk

    def one(args):
        return batch_energy(params, *args, xp=jnp)

    scores = jax.lax.map(one, (
        t.reshape(n, chunk, 3),
        q.reshape(n, chunk, 4),
        a_rec.reshape(n, chunk, -1),
        a_lig.reshape(n, chunk, -1),
    ))
    return scores.reshape(-1)[:g]


# -- one GSO step -----------------------------------------------------------


def gso_step(params: BatchScoringParams, state: SwarmState, randoms,
             energy_fn=None) -> tuple:
    """One full GSO iteration; returns (new_state, StepOutput)."""
    if energy_fn is None:
        energy_fn = functools.partial(batch_energy_chunked, chunk=0)

    g = state.t.shape[0]
    dtype = state.t.dtype

    # 1. Scoring + luciferin update (reference src/glowworm.rs:61-72).
    #    A glowworm moved in the last movement phase iff it had neighbors
    #    (init_state seeds num_neighbors=1 so the first step scores all,
    #    the reference's step==0 branch); energy paths may use the gate to
    #    skip rescoring unmoved poses — the reference's exact semantics.
    moved_prev = state.num_neighbors > 0
    scoring = energy_fn(params, state.t, state.q, state.a_rec, state.a_lig,
                        moved=moved_prev, prev_scoring=state.scoring)
    scoring = scoring.astype(dtype)
    luciferin = (1.0 - C.GSO_RHO) * state.luciferin + C.GSO_GAMMA * scoring

    # 2. Neighbor search (src/swarm.rs:86-102): j neighbor of i iff
    #    L_i < L_j and dist(t_i, t_j) < vision_i.
    diff = state.t[:, None, :] - state.t[None, :, :]
    dist = jnp.sqrt((diff * diff).sum(-1))
    brighter = luciferin[:, None] < luciferin[None, :]
    mask = brighter & (dist < state.vision[:, None])
    mask = mask & ~jnp.eye(g, dtype=bool)
    num_neighbors = mask.sum(axis=1).astype(jnp.int32)
    has_nb = mask.any(axis=1)

    # 3. Roulette selection (src/glowworm.rs:98-126): weights are the
    #    luciferin differences, normalised; select first neighbor whose
    #    cumulative probability reaches the uniform draw.
    w = jnp.where(mask, luciferin[None, :] - luciferin[:, None],
                  jnp.zeros((), dtype))
    total = jnp.cumsum(w, axis=1)[:, -1]   # sequential-order total, like the
    total_safe = jnp.where(total > 0, total, jnp.ones_like(total))
    # Normalise each weight individually, then accumulate — the reference's
    # exact arithmetic order (src/glowworm.rs:104-111 then :119-124), which
    # keeps trajectories bit-comparable deeper into the run.
    cump = jnp.cumsum(w / total_safe[:, None], axis=1)
    ge = (cump >= randoms.astype(dtype)[:, None]) & mask
    # Float-safety net: guarantee the last neighbor is selectable even if
    # rounding left the full cumulative sum a hair under the threshold.
    col = jnp.arange(g)[None, :]
    last_nb = (g - 1) - jnp.argmax(mask[:, ::-1], axis=1)
    ge = ge | (mask & (col == last_nb[:, None]))
    sel = jnp.argmax(ge, axis=1)
    self_idx = jnp.arange(g)
    sel = jnp.where(has_nb, sel, self_idx)
    moved = has_nb

    # 4. Movement toward the snapshotted pose (src/glowworm.rs:128-190).
    mo = moved[:, None]
    delta = state.t[sel] - state.t
    norm = jnp.sqrt((delta * delta).sum(-1, keepdims=True))
    norm = jnp.where(norm > 0, norm, jnp.ones_like(norm))
    t_new = jnp.where(mo, state.t + delta * (C.DEFAULT_TRANSLATION_STEP / norm), state.t)

    q_slerped = qt.slerp(state.q, state.q[sel], C.DEFAULT_ROTATION_STEP, xp=jnp)
    q_new = jnp.where(mo, q_slerped, state.q)

    def move_anm(a):
        if a.shape[1] == 0:
            return a
        d = a[sel] - a
        n = jnp.sqrt((d * d).sum(-1, keepdims=True))
        n = jnp.where(n > 0, n, jnp.ones_like(n))
        return jnp.where(mo, a + d * (C.DEFAULT_NMODES_STEP / n), a)

    a_rec_new = move_anm(state.a_rec) if params.use_anm else state.a_rec
    a_lig_new = move_anm(state.a_lig) if params.use_anm else state.a_lig

    # 5. Vision-range update (src/glowworm.rs:91-96).
    vision = jnp.minimum(
        C.GSO_MAX_VISION_RANGE,
        jnp.maximum(0.0, state.vision + C.GSO_BETA
                    * (C.GSO_MAX_NEIGHBORS - num_neighbors.astype(dtype))))

    new_state = SwarmState(t_new, q_new, a_rec_new, a_lig_new,
                           luciferin, vision, scoring, num_neighbors)
    out = StepOutput(t_new, q_new, a_rec_new, a_lig_new,
                     luciferin, vision, scoring, num_neighbors)
    return new_state, out


def run_swarm(params: BatchScoringParams, state: SwarmState, randoms,
              energy_chunk: int = 0, energy_fn=None):
    """Scan ``steps`` GSO iterations; randoms is (steps, G).

    Returns (final_state, StepOutput stacked over steps).  ``energy_fn``
    overrides the XLA pair-energy path (e.g. the DFIRE pair kernel from
    engine.energy_pallas).
    """
    if energy_fn is None:
        energy_fn = functools.partial(batch_energy_chunked, chunk=energy_chunk)

    def body(st, r):
        return gso_step(params, st, r, energy_fn=energy_fn)

    return jax.lax.scan(body, state, randoms)


@functools.partial(jax.jit, static_argnames=("energy_chunk",))
def run_swarm_jit(params, state, randoms, energy_chunk: int = 0):
    return run_swarm(params, state, randoms, energy_chunk)


# -- host-facing runner -----------------------------------------------------


def pick_energy_mode(params: BatchScoringParams) -> str:
    """Resolve energy_mode='auto': the DFIRE pair kernel on a GPU, else the
    XLA path.  On the H100 the kernel was faster than XLA end to end, or
    level with it within the spread, at every shape measured, from 640 x
    32 atoms to the 1k4c shape, with poses clear of the receptor and in
    contact (PERF.md)."""
    if params.method == "dfire" and jax.default_backend() == "gpu":
        return "pallas"
    return "xla"


def mixed_precision_energy(energy_fn, state_dtype, energy_dtype):
    """Wrap an energy_fn to score at ``energy_dtype`` while the swarm
    state stays at ``state_dtype`` (pose args cast up, result cast back).
    No-op when the dtypes agree (or energy_dtype is None).  The wrapped
    fn expects ``params`` already at energy_dtype (GsoJaxRunner uploads
    them so)."""
    if energy_dtype is None or jnp.dtype(state_dtype) == jnp.dtype(energy_dtype):
        return energy_fn

    def wrapped(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
        kw = {}
        if moved is not None:
            kw["moved"] = moved
        if prev_scoring is not None:
            kw["prev_scoring"] = prev_scoring.astype(energy_dtype)
        sc = energy_fn(p, t.astype(energy_dtype), q.astype(energy_dtype),
                       a_rec.astype(energy_dtype),
                       a_lig.astype(energy_dtype), **kw)
        return sc.astype(state_dtype)

    return wrapped


class GsoJaxRunner:
    """Host wrapper: precomputes the RNG stream, jits the scan, writes
    snapshots in the reference cadence/format."""

    def __init__(self, params: BatchScoringParams, positions, seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 output_directory: Optional[str] = None,
                 dtype=jnp.float32, energy_chunk: int = 0,
                 energy_mode: str = "xla", cull: bool = True,
                 rng_mode: str = "reference",
                 interpret: bool = False, energy_dtype=None):
        from ..utils.rng import uniform_f64_stream

        if energy_mode == "auto":
            energy_mode = pick_energy_mode(params)
        if energy_mode not in ("xla", "pallas"):
            raise ValueError(f"unknown energy_mode {energy_mode!r}")
        self.energy_mode = energy_mode
        if energy_mode == "pallas":
            # Spatially sort the atom axes so the conservative tile cull
            # bites (semantics unchanged; energy_pallas.spatial_sort_params).
            from .energy_pallas import spatial_sort_params
            params = spatial_sort_params(params)
        self.params = device_params(params, dtype=dtype)
        self.state = init_state(positions, use_anm, anm_rec, anm_lig, dtype=dtype)
        self.seed = seed
        self.use_anm = use_anm
        self.output_directory = output_directory
        self.energy_chunk = energy_chunk
        if rng_mode == "reference":
            # Bit-exact rand-0.7 stream (host-side, comparable with the
            # reference engine run-for-run).
            self._stream = functools.partial(uniform_f64_stream, seed)
        elif rng_mode == "native":
            # JAX-native threefry stream, generated on device.
            def native_stream(n):
                key = jax.random.PRNGKey(seed)
                return jax.random.uniform(key, (n,), dtype=jnp.float32)
            self._stream = native_stream
        else:
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        self._start_step = 0  # completed steps (for resume)
        self._initial_state = self.state  # for reset() (bench repeats)
        e_dtype = jnp.dtype(energy_dtype) if energy_dtype is not None else None
        mixed = e_dtype is not None and e_dtype != jnp.dtype(dtype)
        if mixed:
            # Mixed-precision scoring (SURVEY §7 precision policy): swarm
            # state + movement stay at ``dtype``; the scoring path (params
            # upload + pair energies) runs at ``energy_dtype``.  On CPU this
            # isolates which precision term binds the f32 trajectory
            # horizon; params feed nothing but the energy (movement reads
            # only params.use_anm).
            self.params = device_params(params, dtype=e_dtype)
        if energy_mode == "pallas":
            from .energy_pallas import make_pallas_energy_fn
            energy_fn = make_pallas_energy_fn(params, cull=cull,
                                              interpret=interpret)
        else:
            energy_fn = functools.partial(batch_energy_chunked,
                                          chunk=energy_chunk)
        # The pair-energy function the runs use: (params, t, q, a_rec,
        # a_lig) -> (G,) scores.
        self.energy_fn = mixed_precision_energy(energy_fn, dtype, e_dtype)
        if energy_mode == "xla" and not mixed:
            self._run_jit = functools.partial(run_swarm_jit,
                                              energy_chunk=energy_chunk)
        else:
            self._run_jit = jax.jit(
                lambda p, s, r: run_swarm(p, s, r, energy_fn=self.energy_fn))

    def load_snapshot(self, path, step: int = None) -> None:
        """Resume from a gso_N.out snapshot (written at ``step``).

        Prefers the full-precision ``.npz`` sidecar written next to every
        snapshot — resume is then bit-identical to the uninterrupted run.
        Falls back to parsing the text file (7/8-decimal quantization) for
        snapshots produced without a sidecar (e.g. by the reference
        binary), where ``step`` must be given.  The RNG position is
        reconstructed as step*G consumed draws (the stream is exactly one
        draw per glowworm per step, reference src/swarm.rs:118).  This is
        the resume path the reference lacks (it always restarts from
        initial_positions, reference src/bin/lightdock-rust.rs:188).
        """
        from ..utils.output import read_gso_output, read_state_sidecar
        from ..utils.positions import split_positions

        dtype = self.state.t.dtype
        sidecar = read_state_sidecar(path)
        if sidecar is not None:
            sc_step, arrays = sidecar
            self.state = SwarmState(
                **{k: jnp.asarray(arrays[k]) for k in SwarmState._fields})
            self._start_step = int(step) if step else sc_step
            return
        if step is None:
            raise ValueError(
                f"no sidecar next to {path}; pass the snapshot's step")
        poses, luc, nn, vis, sco = read_gso_output(path)
        t, q, ar, al = split_positions(poses, self.use_anm,
                                       self.state.a_rec.shape[1],
                                       self.state.a_lig.shape[1])
        self.state = SwarmState(
            t=jnp.asarray(t, dtype=dtype),
            q=jnp.asarray(q, dtype=dtype),
            a_rec=jnp.asarray(ar, dtype=dtype),
            a_lig=jnp.asarray(al, dtype=dtype),
            luciferin=jnp.asarray(luc, dtype=dtype),
            vision=jnp.asarray(vis, dtype=dtype),
            scoring=jnp.asarray(sco, dtype=dtype),
            num_neighbors=jnp.asarray(nn, dtype=jnp.int32),
        )
        self._start_step = int(step)

    def reset(self) -> None:
        """Rewind to the initial swarm state (bench repeats must restart
        the trajectory: a converged swarm has fewer moved poses, so the
        rescoring gate would make re-timed segments optimistically fast)."""
        self._start_step = 0
        self.state = self._initial_state

    def run(self, steps: int):
        g = self.state.t.shape[0]
        start = self._start_step
        remaining = steps - start
        if remaining <= 0:
            return self.state, None
        randoms = self._stream(steps * g)[start * g:].reshape(remaining, g)
        randoms = jnp.asarray(randoms, dtype=self.state.t.dtype)
        final_state, outs = self._run_jit(self.params, self.state, randoms)
        self.state = jax.block_until_ready(final_state)
        if self.output_directory is not None:
            self._write_snapshots(outs, steps, start)
        self._start_step = steps
        return final_state, outs

    def run_segmented(self, steps: int, segment: int = 10, metrics=None):
        """Run in fixed-length segments (one compiled scan reused for all).

        Bounds the on-device footprint of the per-step outputs to one
        segment and makes snapshots appear incrementally — a crash loses
        at most one segment (the resume path picks up from the last
        snapshot).  Segment boundaries align with the save cadence.
        """
        import time as _time

        g = self.state.t.shape[0]
        dtype = self.state.t.dtype
        # Upload the whole random stream once; segments slice it on device
        # so the dispatch chain stays asynchronous (no host->device
        # transfer or sync between segments unless snapshots/metrics need
        # one).
        randoms_all = jnp.asarray(
            self._stream(steps * g)[self._start_step * g:].reshape(-1, g),
            dtype=dtype)
        base = self._start_step
        final_state, outs = self.state, None
        while self._start_step < steps:
            start = self._start_step
            target = min(start + segment, steps)
            rnd = jax.lax.slice_in_dim(randoms_all, start - base, target - base)
            t0 = _time.time()
            final_state, outs = self._run_jit(self.params, self.state, rnd)
            self.state = final_state
            if self.output_directory is not None:
                self._write_snapshots(outs, target, start)
            self._start_step = target
            if metrics is not None:
                np.asarray(final_state.scoring)  # force completion for timing
                metrics.segment(start, target, (target - start) * g,
                                _time.time() - t0)
        return final_state, outs

    def _poses_at(self, outs: StepOutput, i: int) -> np.ndarray:
        cols = [np.asarray(outs.t[i]), np.asarray(outs.q[i])]
        if self.use_anm and outs.a_rec.shape[-1] > 0:
            cols.append(np.asarray(outs.a_rec[i]))
        if self.use_anm and outs.a_lig.shape[-1] > 0:
            cols.append(np.asarray(outs.a_lig[i]))
        return np.concatenate(cols, axis=1).astype(np.float64)

    def _write_snapshots(self, outs: StepOutput, steps: int, start: int = 0):
        import pathlib

        from ..utils.output import write_gso_output, write_state_sidecar

        outdir = pathlib.Path(self.output_directory)
        outdir.mkdir(parents=True, exist_ok=True)
        for step in range(start + 1, steps + 1):
            if step % 10 == 0 or step == 1:
                i = step - 1 - start
                path = outdir / f"gso_{step}.out"
                write_gso_output(
                    path,
                    self._poses_at(outs, i),
                    np.asarray(outs.luciferin[i], dtype=np.float64),
                    np.asarray(outs.num_neighbors[i]),
                    np.asarray(outs.vision[i], dtype=np.float64),
                    np.asarray(outs.scoring[i], dtype=np.float64),
                )
                # Full-precision sidecar: the StepOutput after step i IS
                # the post-step SwarmState, so resume from it is bit-exact.
                write_state_sidecar(
                    path, step,
                    **{k: np.asarray(getattr(outs, k)[i])
                       for k in SwarmState._fields})
