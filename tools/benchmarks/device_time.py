"""Device-time estimates for the steady-state programs.

Each program is wrapped in a ``lax.scan`` that chains it K times
device-side (outputs feed back as inputs, constants closed over), so one
dispatch executes K iterations back-to-back:

    t(K) = host_overhead + K * device_time

Timing the K=1 and K=9 variants and differencing removes the per-call
host overhead (dispatch, argument handling, the final sync); the MIN
over repeats filters host noise, which only ever adds time.  The result
is per-iteration device time, without an idle share or per-kernel
breakdown (those need a profiler trace).

Used by bench.py (device-fps columns next to wall fps) and
tools/benchmarks/perf_audit.py.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def _time_once(fn, *args) -> float:
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def measure_chained(make_chained: Callable[[int], Callable], args,
                    k: int = 9, repeats: int = 5) -> Tuple[float, float]:
    """Return (device_seconds_per_iteration, dispatch_overhead_seconds).

    ``make_chained(K)`` must return a jitted callable running the program
    K times back-to-back on device over ``args``.
    """
    f1, fk = make_chained(1), make_chained(k)
    _time_once(f1, *args)      # compile
    _time_once(fk, *args)      # compile
    t1 = min(_time_once(f1, *args) for _ in range(repeats))
    tk = min(_time_once(fk, *args) for _ in range(repeats))
    dev = max((tk - t1) / (k - 1), 1e-9)
    overhead = max(t1 - dev, 0.0)
    return dev, overhead


# ---------------------------------------------------------------- programs

def slam_window_chain(cfg, window: int):
    """Chained SLAM window tracker (runtime/windowed.py).  Returns
    (make_chained, needs_args=(ms, payload, state_T, assoc, inlier,
    ref_kf))."""
    from orbslam2_tpu.runtime import windowed

    tracker = windowed.make_slam_window_tracker(cfg, window)

    def make(K: int):
        @jax.jit
        def run(ms, payload, state_T, assoc, inlier, ref_kf):
            def body(c, _):
                sT, a, inl = c
                out = tracker(ms, payload, sT, a, inl, ref_kf)
                return ((out.state_T, out.last_assoc, out.last_inlier),
                        out.summaries[0, 0])
            c, ys = jax.lax.scan(body, (state_T, assoc, inlier), None,
                                 length=K)
            return c[0], ys
        return run

    return make


def loc_window_chain(cfg, window: int):
    """Chained LOC streaming window tracker (runtime/streaming.py)."""
    from orbslam2_tpu.runtime import streaming

    tracker = streaming.make_window_tracker(cfg, window)

    def make(K: int):
        @jax.jit
        def run(ms, flat, state_T, assoc, ref_kf):
            def body(c, _):
                sT, a = c
                out = tracker(ms, flat, sT, a, ref_kf)
                return (out.state_T, out.assoc), out.summaries[0, 0]
            c, ys = jax.lax.scan(body, (state_T, assoc), None, length=K)
            return c[0], ys
        return run

    return make


def mapping_chain(cfg, window: int):
    """Chained windowed mapping step (keyframe insert + triangulate +
    fuse + local BA + cull).  The map state feeds back; the keyframe slot
    advances per iteration so inserts do not collide."""
    from orbslam2_tpu.runtime import windowed

    kf_step = windowed.make_window_mapping_step(cfg)

    def make(K: int):
        @jax.jit
        def run(ms, fds, assocs, Tcws, kf_slot0, kf_ord0, parent,
                frame_id, vis, fnd):
            def body(c, i):
                ms_c, slot, ordn = c
                ms2, stats = kf_step(
                    ms_c, fds, assocs, Tcws, jnp.int32(0), slot, ordn,
                    parent, frame_id + i, jnp.float32(0.0),
                    jnp.bool_(True), jnp.bool_(True), vis, fnd)
                return (ms2, slot + 1, ordn + 1), stats[0]
            c, ys = jax.lax.scan(
                body, (ms, kf_slot0, kf_ord0), jnp.arange(K))
            return ys
        return run

    return make


def detect_chain(cfg, voc):
    """Chained loop-detection prologue (BoW + DB matvec + consistency
    rows in one dispatch; runtime/loop_closing.py detect_step)."""
    from orbslam2_tpu.runtime import loop_closing

    detect_step = loop_closing.make_loop_fns(cfg, voc)[-1]

    def make(K: int):
        @jax.jit
        def run(ms, db, kf):
            def body(db_c, _):
                db2, vec, cand = detect_step(ms, db_c, kf)
                return db2, cand[0, 0]
            db2, ys = jax.lax.scan(body, db, None, length=K)
            return ys
        return run

    return make
