"""Streaming window tracking: N frames per device program.

Motivation: every dispatch, host→device transfer and synchronous fetch
costs host latency, so a per-frame host loop floors at that latency no
matter how fast the kernels are.  (Per-dispatch cost on the H100: not
measured.)

The answer here is to keep the whole *tracking* recurrence on device and
stream frames in windows:

  * images arrive as ONE flat uint8 buffer per window (fast H2D path;
    cameras and datasets are 8-bit anyway) and are reshaped/converted
    on device;
  * a ``lax.scan`` over the window runs frontend → motion-model matching
    → pose optimization → local-map matching → pose optimization per
    frame, carrying (pose, velocity, associations) across frames;
  * outputs are packed into four buffers; only ``summaries`` ([B, 40])
    is ever fetched by the host — the rest feed the next window call
    device-to-device.

This is the throughput mode for localization-only serving (the
reference's LOC benchmarks, executeBenchmarks.sh) and the batched front
half of SLAM mode: keyframe decisions are made at window granularity by
the host from the returned summaries (window size bounds keyframe
latency, typically 4-8 frames at camera rate).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import SlamConfig
from orbslam2_tpu.models import frame as frame_mod
from orbslam2_tpu.models import map_state as M
from orbslam2_tpu.runtime import tracking


class WindowResult(NamedTuple):
    summaries: jax.Array   # [B, 40] per-frame packed summaries (host-fetched)
    state_T: jax.Array     # [2, 4, 4] (last Tcw, previous Tcw) — device-kept
    assoc: jax.Array       # [N] final frame's inlier associations (−1 none)
    counters: jax.Array    # [2, P] int32 (visible_total, found_total)


def pack_window_uint8(left_right_frames) -> "np.ndarray":  # noqa: F821
    """Host helper: list of (left, right) uint8 [H, W] pairs → one flat
    uint8 buffer for the fast 1-D H2D path."""
    import numpy as np
    parts = []
    for l, r in left_right_frames:
        parts.append(np.ascontiguousarray(l, dtype=np.uint8).reshape(-1))
        parts.append(np.ascontiguousarray(r, dtype=np.uint8).reshape(-1))
    return np.concatenate(parts)


def make_window_tracker(cfg: SlamConfig, window: int):
    """Build track_window: (ms, flat_u8 [B·2·H·W], state_T, assoc0, ref_kf)
    → WindowResult.  ``window`` (B) is static."""
    _, track_fn, *_ = tracking.make_tracking_fns(cfg)
    frontend = frame_mod.make_frontend_stereo(cfg)
    H, W = cfg.camera.height, cfg.camera.width
    B = window

    @jax.jit
    def track_window(ms: M.MapState, flat_u8: jax.Array,
                     state_T: jax.Array, assoc0: jax.Array,
                     ref_kf: jax.Array) -> WindowResult:
        P = ms.P
        imgs = flat_u8.reshape(B, 2, H, W).astype(jnp.float32)

        def step(carry, xs):
            T_prev, T_prev2, assoc, vis, fnd = carry
            lr = xs
            fd = frontend(lr[0], lr[1])
            # constant-velocity prediction (Tracking.cc:967)
            vel = T_prev @ jnp.linalg.inv(T_prev2)
            pred = vel @ T_prev
            res = track_fn(ms, fd, pred, assoc, assoc >= 0, ref_kf)
            vis = vis + res.visible_mask.astype(jnp.int32)
            fnd = fnd + res.found_mask.astype(jnp.int32)
            carry = (res.Tcw, T_prev, res.assoc, vis, fnd)
            return carry, res.summary

        zeros = jnp.zeros((P,), jnp.int32)
        (Tl, Tp, assoc, vis, fnd), summaries = jax.lax.scan(
            step, (state_T[0], state_T[1], assoc0, zeros, zeros), imgs)
        return WindowResult(
            summaries=summaries,
            state_T=jnp.stack([Tl, Tp]),
            assoc=assoc,
            counters=jnp.stack([vis, fnd]))

    return track_window
