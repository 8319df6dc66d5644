"""ORB feature extraction: pyramid FAST + orientation + rotated BRIEF.

Static-shape redesign of ``ORBextractor`` (src/ORBextractor.cc:405-948):

* per-cell two-threshold FAST  → one exact-score pass + masked compare
  (ops/fast.py)
* sequential quadtree NMS (``DistributeOctTree``, ORBextractor.cc:533)
  → grid-bucketed rank-penalized top-k.  Only the quadtree's
  *spatial-uniformity contract* matters: features are ranked
  (cell-rank, −response) so every cell contributes its best feature
  before any cell contributes its second-best — the same "max response
  per spatial node" policy, in one static-shape jnp.top_k.
* IC-angle orientation (``IC_Angle``, ORBextractor.cc:72) → two 31×31
  moment convolutions over the whole level + per-keypoint gather.
* rotated BRIEF (``computeOrbDescriptor``, ORBextractor.cc:103) →
  batched gather of 512 rotated sample points per keypoint, bit-packed
  into [N, 8] uint32 via a power-of-two matmul.

All shapes are static per (image size, config): variable keypoint counts
become fixed capacities with validity masks.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import OrbConfig
from orbslam2_tpu.ops import fast as fast_ops
from orbslam2_tpu.ops import image as image_ops
from orbslam2_tpu.ops import pattern as pattern_mod
from orbslam2_tpu.ops import sampling

CELL = 30  # detection/bucketing cell size in px (ORBextractor.cc:779 W=30)
TOPK_PER_CELL = 8


class Features(NamedTuple):
    """Fixed-capacity feature set for one image (the array analogue of the
    keypoint/descriptor members of ``Frame``, include/Frame.h)."""

    xy: jax.Array        # [N, 2] float32 — (x, y) at level-0 scale, raw coords
    level: jax.Array     # [N] int32 — pyramid octave
    angle: jax.Array     # [N] float32 — orientation, radians
    response: jax.Array  # [N] float32 — FAST score
    valid: jax.Array     # [N] bool
    desc: jax.Array      # [N, 8] uint32 — 256-bit descriptor

    @property
    def n(self) -> int:
        return self.xy.shape[-2]


class OrbLevels(NamedTuple):
    """Static per-level metadata (mvScaleFactor/mvLevelSigma2 analogue)."""

    scales: Tuple[float, ...]        # scale of level l vs level 0 (≥1)
    caps: Tuple[int, ...]            # feature capacity per level
    sigma2: Tuple[float, ...]        # scale^2 per level


def level_plan(cfg: OrbConfig) -> OrbLevels:
    """Distribute the feature budget across levels like the reference ctor
    (geometric series in 1/scaleFactor, ORBextractor.cc:421-434), but summing
    exactly to the padded capacity so concatenated outputs have static size."""
    n_pad = cfg.n_features_padded
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv ** l for l in range(cfg.n_levels)])
    raw = weights / weights.sum() * n_pad
    caps = np.floor(raw).astype(int)
    # hand out the rounding remainder to the finest levels first
    rem = n_pad - caps.sum()
    order = np.argsort(-(raw - caps))
    caps[order[:rem]] += 1
    scales = tuple(cfg.scale_factor ** l for l in range(cfg.n_levels))
    return OrbLevels(scales=scales, caps=tuple(int(c) for c in caps),
                     sigma2=tuple(s * s for s in scales))


# ------------------------------------------------------------ per level ----

def _select_keypoints(score: jax.Array, cap: int, ini_th: float, min_th: float,
                      border: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Masked per-cell two-threshold FAST + rank-penalized bucketed top-k.

    Returns (xy [cap, 2] int32 level coords, response [cap] f32, valid [cap]).
    """
    h, w = score.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    score = jnp.where(inb, score, 0.0)

    hc, wc = -(-h // CELL), -(-w // CELL)
    pad_h, pad_w = hc * CELL - h, wc * CELL - w
    sp = jnp.pad(score, ((0, pad_h), (0, pad_w)))
    cells = sp.reshape(hc, CELL, wc, CELL).transpose(0, 2, 1, 3)
    cells = cells.reshape(hc * wc, CELL * CELL)                  # [C, 900]

    cell_max = jnp.max(cells, axis=1, keepdims=True)
    # two-threshold fallback: normally require score > iniTh; in cells where
    # nothing clears iniTh, accept score > minTh (Tracking's low-contrast
    # rescue, ORBextractor.cc:803-810)
    keep = (cells > ini_th) | ((cells > min_th) & (cell_max <= ini_th))
    cells = jnp.where(keep, cells, 0.0)

    # per-cell top-k, rank-penalized so cells round-robin by rank.
    # Iterative max+mask instead of lax.top_k: top_k lowers to a full
    # per-row sort (measured ~6 ms here); 8 masked max passes are pure
    # elementwise work.
    vals_l, idx_l = [], []
    work = cells
    col = jax.lax.broadcasted_iota(jnp.int32, work.shape, 1)
    for _ in range(TOPK_PER_CELL):
        m = jnp.max(work, axis=1)                                # [C]
        am = jnp.argmax(work, axis=1)                            # [C]
        vals_l.append(m)
        idx_l.append(am)
        work = jnp.where(col == am[:, None], -jnp.inf, work)
    vals = jnp.stack(vals_l, axis=1)                             # [C, K]
    idx = jnp.stack(idx_l, axis=1)
    rank_pen = jnp.arange(TOPK_PER_CELL, dtype=jnp.float32) * 1024.0
    prio = jnp.where(vals > 0.0, vals - rank_pen[None, :], -jnp.inf)

    flat_prio = prio.reshape(-1)
    flat_vals = vals.reshape(-1)
    # recover level-image coordinates from (cell, within-cell) indices
    c_ids = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, TOPK_PER_CELL), 0)
    cy, cx = c_ids // wc, c_ids % wc
    iy, ix = idx // CELL, idx % CELL
    kp_y = (cy * CELL + iy).reshape(-1)
    kp_x = (cx * CELL + ix).reshape(-1)

    top_prio, top_i = jax.lax.top_k(flat_prio, cap)
    valid = top_prio > -jnp.inf
    out_xy = jnp.stack([kp_x[top_i], kp_y[top_i]], axis=-1)
    out_resp = flat_vals[top_i]
    return jnp.where(valid[:, None], out_xy, 0), \
        jnp.where(valid, out_resp, 0.0), valid


@functools.lru_cache(maxsize=None)
def _moment_kernels():
    disc = pattern_mod.ic_angle_disc()
    r = pattern_mod.HALF_PATCH
    coords = np.arange(-r, r + 1, dtype=np.float32)
    kx = (disc * coords[None, :]).reshape(-1)
    ky = (disc * coords[:, None]).reshape(-1)
    return np.stack([kx, ky], axis=-1)        # [961, 2]


def _orientation_maps(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Level image → (m10 map, m01 map) at every pixel.  Kept for oracle
    tests; production uses keypoint_angles (per-keypoint gather — moments
    at every pixel would be a single-channel 31×31 conv, ~1000× the
    work)."""
    k = jnp.asarray(_moment_kernels().reshape(31, 31, 2).transpose(2, 0, 1))
    r = pattern_mod.HALF_PATCH
    x = jnp.pad(img, ((r, r), (r, r)), mode="edge")[None, None]
    out = jax.lax.conv_general_dilated(
        x, k[:, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0]
    return out[0], out[1]                     # m10, m01


def keypoint_angles(level_img: jax.Array, xy: jax.Array) -> jax.Array:
    """IC angles at the keypoints only: one-hot-matmul patch extraction
    (ops/sampling.py) then contraction with the two moment masks
    ([cap, 961] × [961, 2]).  DEFAULT precision runs as TF32 on the H100;
    parity with the CPU in PERF.md."""
    r = pattern_mod.HALF_PATCH
    patches = sampling.extract_patches(
        level_img, xy[:, 0], xy[:, 1], r, r).reshape(-1, 961)
    m = jnp.matmul(patches, jnp.asarray(_moment_kernels()),
                   precision=jax.lax.Precision.DEFAULT)  # [cap, 2]
    return jnp.arctan2(m[:, 1], m[:, 0])


DESC_HALF = 20   # ≥ ceil(PATTERN_RADIUS·√2): covers any rotated sample


def _descriptors(blurred: jax.Array, xy: jax.Array, angle: jax.Array
                 ) -> jax.Array:
    """Rotated BRIEF: [cap, 2] int coords + [cap] angles → [cap, 8] uint32.

    One 49×49 patch per keypoint (one-hot matmuls) + one-hot point
    sampling of the 512 steered pattern positions — all matmul work, no
    image-wide gathers (ops/sampling.py rationale)."""
    pat = jnp.asarray(pattern_mod.brief_pattern())      # [256, 4] int32
    px = jnp.concatenate([pat[:, 0], pat[:, 2]]).astype(jnp.float32)  # [512]
    py = jnp.concatenate([pat[:, 1], pat[:, 3]]).astype(jnp.float32)
    ca, sa = jnp.cos(angle), jnp.sin(angle)             # [cap]
    # steered pattern, rounded to ints (computeOrbDescriptor's cvRound)
    rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    # edge-pad so border keypoints keep clamp-sampling semantics (the
    # extractor's FAST border is 19 px < DESC_HALF)
    padded = jnp.pad(blurred, DESC_HALF, mode="edge")
    patches = sampling.extract_patches(padded, xy[:, 0] + DESC_HALF,
                                       xy[:, 1] + DESC_HALF,
                                       DESC_HALF, DESC_HALF)
    vals = sampling.sample_points(
        patches,
        rx.astype(jnp.int32) + DESC_HALF,
        ry.astype(jnp.int32) + DESC_HALF)               # [cap, 512]
    bits = (vals[:, :256] < vals[:, 256:])              # τ(p1 < p2)
    packed = bits.reshape(-1, 8, 32).astype(jnp.uint32)
    pow2 = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(packed * pow2[None, None, :], axis=-1, dtype=jnp.uint32)


def extract_level(level_img: jax.Array, cap: int, cfg: OrbConfig
                  ) -> Tuple[jax.Array, ...]:
    """One pyramid level → (xy_lvl f32, angle, response, valid, desc)."""
    score = fast_ops.nms_3x3(fast_ops.fast_score(level_img))
    xy, resp, valid = _select_keypoints(
        score, cap, float(cfg.ini_th_fast), float(cfg.min_th_fast),
        border=cfg.edge_threshold)
    angle = keypoint_angles(level_img, xy)
    blurred = image_ops.gaussian_blur(level_img, 7, 2.0)
    desc = _descriptors(blurred, xy, angle)
    return xy.astype(jnp.float32), angle, resp, valid, desc


def extract(img: jax.Array, cfg: OrbConfig) -> Features:
    """[H, W] float32 grayscale → Features with capacity n_features_padded.

    The full ORBextractor::operator() (src/ORBextractor.cc:858) equivalent.
    """
    plan = level_plan(cfg)
    pyr = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    parts = []
    for l, level_img in enumerate(pyr):
        xy, angle, resp, valid, desc = extract_level(level_img, plan.caps[l], cfg)
        xy0 = xy * plan.scales[l]          # back to level-0 coordinates
        lvl = jnp.full((plan.caps[l],), l, jnp.int32)
        parts.append((xy0, lvl, angle, resp, valid, desc))
    xy = jnp.concatenate([p[0] for p in parts])
    level = jnp.concatenate([p[1] for p in parts])
    angle = jnp.concatenate([p[2] for p in parts])
    response = jnp.concatenate([p[3] for p in parts])
    valid = jnp.concatenate([p[4] for p in parts])
    desc = jnp.concatenate([p[5] for p in parts])
    return Features(xy=xy, level=level, angle=angle, response=response,
                    valid=valid, desc=desc)
