"""Stereo rectification: the cv::initUndistortRectifyMap / cv::remap pair
of the EuRoC driver (/root/reference/Test/Replay/Stereo/stereo_euroc.cc:72-100)
re-implemented as array programs.

The reference builds per-pixel source-coordinate maps once from the
LEFT./RIGHT. calibration blocks of Stereo-EuRoC.yaml (K/D/R/P) and remaps
every incoming frame.  Here:

  * :func:`init_undistort_rectify_map` — the map build (numpy, once per
    run).  For each DESTINATION pixel: lift through the rectified
    projection P, rotate by R⁻¹, apply the rad-tan distortion of K/D,
    project — giving the SOURCE pixel to sample.
  * :func:`remap_bilinear` — jittable bilinear sampling (gather of the 4
    neighbours + lerp) so rectification can fuse into a device frontend.
  * :class:`StereoRectifier` — host-facing wrapper with precomputed
    integer indices/weights (vectorized numpy fast path for the replay
    CLIs) and a jitted device path.
  * :func:`load_rectification` — pull the LEFT./RIGHT. blocks out of a
    parsed settings file (config._parse_opencv_yaml already yields the
    !!opencv-matrix blocks as numpy arrays); returns None when the file
    carries no rectification (all non-EuRoC configs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def init_undistort_rectify_map(K: np.ndarray, D: np.ndarray, R: np.ndarray,
                               P3: np.ndarray, width: int, height: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap semantics (stereo_euroc.cc:98-99).

    K [3,3] source intrinsics, D [1,n] rad-tan distortion (k1 k2 p1 p2
    [k3]), R [3,3] rectifying rotation, P3 [3,3] = P.rowRange(0,3)
    .colRange(0,3) new projection.  Returns (map_x, map_y) float32 [H,W]:
    source coordinates for each destination pixel."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    R = np.asarray(R, np.float64)
    P3 = np.asarray(P3, np.float64)

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    # lift through the NEW projection, rotate back to the source frame
    Pinv = np.linalg.inv(P3)
    x = Pinv[0, 0] * u + Pinv[0, 1] * v + Pinv[0, 2]
    y = Pinv[1, 0] * u + Pinv[1, 1] * v + Pinv[1, 2]
    w = Pinv[2, 0] * u + Pinv[2, 1] * v + Pinv[2, 2]
    Rinv = R.T                      # R maps source→rectified
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2] * w
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2] * w
    W = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2] * w
    xn = X / W
    yn = Y / W
    # rad-tan distortion of the SOURCE camera (camera.distort_points
    # formulation, Frame::UndistortKeyPoints inverse direction)
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: jax.Array, map_x: jax.Array, map_y: jax.Array
                   ) -> jax.Array:
    """Jittable cv::remap(..., INTER_LINEAR): out[v,u] =
    bilinear(img, map_y[v,u], map_x[v,u]); out-of-bounds → 0."""
    H, W = img.shape
    x0 = jnp.floor(map_x).astype(jnp.int32)
    y0 = jnp.floor(map_y).astype(jnp.int32)
    fx = map_x - x0
    fy = map_y - y0
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    x0c = jnp.clip(x0, 0, W - 1)
    y0c = jnp.clip(y0, 0, H - 1)
    x1c = jnp.clip(x0 + 1, 0, W - 1)
    y1c = jnp.clip(y0 + 1, 0, H - 1)
    v00 = img[y0c, x0c]
    v01 = img[y0c, x1c]
    v10 = img[y1c, x0c]
    v11 = img[y1c, x1c]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return jnp.where(inb, out, 0.0)


class RectifyMaps(NamedTuple):
    lx: np.ndarray
    ly: np.ndarray
    rx: np.ndarray
    ry: np.ndarray


class StereoRectifier:
    """Per-frame stereo rectification with precomputed maps.

    Host path (__call__): vectorized-numpy bilinear with precomputed
    integer indices + weights — the replay CLIs' per-frame cost.
    Device path (jit_remap_pair): one jitted program for pipelines that
    keep frames on device."""

    def __init__(self, maps: RectifyMaps):
        self.maps = maps
        self._pre = tuple(self._precompute(mx, my)
                          for mx, my in ((maps.lx, maps.ly),
                                         (maps.rx, maps.ry)))
        self._jit = jax.jit(
            lambda l, r: (remap_bilinear(l, jnp.asarray(maps.lx),
                                         jnp.asarray(maps.ly)),
                          remap_bilinear(r, jnp.asarray(maps.rx),
                                         jnp.asarray(maps.ry))))

    @staticmethod
    def _precompute(mx, my):
        H, W = mx.shape
        x0 = np.floor(mx).astype(np.int32)
        y0 = np.floor(my).astype(np.int32)
        fx = (mx - x0)[..., None]
        fy = (my - y0)[..., None]
        inb = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
        x0c = np.clip(x0, 0, W - 1)
        y0c = np.clip(y0, 0, H - 1)
        x1c = np.clip(x0 + 1, 0, W - 1)
        y1c = np.clip(y0 + 1, 0, H - 1)
        idx = (y0c * W + x0c, y0c * W + x1c, y1c * W + x0c, y1c * W + x1c)
        w = np.concatenate([(1 - fx) * (1 - fy), fx * (1 - fy),
                            (1 - fx) * fy, fx * fy], axis=-1
                           ).astype(np.float32)
        return idx, w, inb

    def _apply(self, img: np.ndarray, pre) -> np.ndarray:
        idx, w, inb = pre
        flat = np.asarray(img, np.float32).reshape(-1)
        out = (flat[idx[0]] * w[..., 0] + flat[idx[1]] * w[..., 1]
               + flat[idx[2]] * w[..., 2] + flat[idx[3]] * w[..., 3])
        return np.where(inb, out, 0.0)

    def __call__(self, left: np.ndarray, right: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return (self._apply(left, self._pre[0]),
                self._apply(right, self._pre[1]))

    def jit_remap_pair(self, left: jax.Array, right: jax.Array):
        return self._jit(left, right)


def load_rectification(settings_path_or_flat) -> Optional[StereoRectifier]:
    """Build a StereoRectifier from a settings file carrying LEFT./RIGHT.
    rectification blocks (Stereo-EuRoC.yaml); None when absent."""
    if isinstance(settings_path_or_flat, dict):
        flat = settings_path_or_flat
    else:
        from orbslam2_tpu.config import _parse_opencv_yaml
        with open(settings_path_or_flat) as f:
            flat = _parse_opencv_yaml(f.read())
    need = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
            "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P"]
    if not all(k in flat and isinstance(flat[k], np.ndarray) for k in need):
        return None
    wl = int(flat.get("LEFT.width", 0))
    hl = int(flat.get("LEFT.height", 0))
    wr = int(flat.get("RIGHT.width", 0))
    hr = int(flat.get("RIGHT.height", 0))
    if not (wl and hl and wr and hr):
        return None
    lx, ly = init_undistort_rectify_map(
        flat["LEFT.K"], flat["LEFT.D"], flat["LEFT.R"],
        np.asarray(flat["LEFT.P"])[:3, :3], wl, hl)
    rx, ry = init_undistort_rectify_map(
        flat["RIGHT.K"], flat["RIGHT.D"], flat["RIGHT.R"],
        np.asarray(flat["RIGHT.P"])[:3, :3], wr, hr)
    return StereoRectifier(RectifyMaps(lx, ly, rx, ry))
