"""Pinhole camera model: projection, back-projection, rad-tan distortion.

Replaces the camera handling scattered through the reference —
``Frame::UndistortKeyPoints`` (src/Frame.cc:402, cv::undistortPoints),
``Frame::UnprojectStereo`` (src/Frame.cc:668), projection in
``Frame::isInFrustum`` (src/Frame.cc:270) and all matchers/optimizer edges.
Batched over arbitrary leading dims; a camera is a small pytree of scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.utils import lie


class Camera(NamedTuple):
    """Static camera intrinsics as a jit-friendly pytree of scalars."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    k1: jax.Array
    k2: jax.Array
    p1: jax.Array
    p2: jax.Array
    k3: jax.Array
    bf: jax.Array          # baseline × fx
    width: jax.Array
    height: jax.Array
    # undistorted-image valid bounds (Frame::ComputeImageBounds, Frame.cc:434)
    min_x: jax.Array
    max_x: jax.Array
    min_y: jax.Array
    max_y: jax.Array

    @property
    def baseline(self) -> jax.Array:
        return self.bf / self.fx

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.array(
            [[self.fx, z, self.cx], [z, self.fy, self.cy], [z, z, o]],
            dtype=jnp.result_type(self.fx))

    @staticmethod
    def from_config(cfg: CameraConfig, dtype=jnp.float32) -> "Camera":
        # IMPORTANT: fields are NUMPY scalars, never device arrays.  A
        # Camera is captured as a closure constant by nearly every jitted
        # function in the package; capturing an eagerly-created device
        # array as a jit constant ties every executable to that buffer,
        # and on some PJRT runtimes degraded *all* subsequent dispatches.
        # NumPy constants are embedded in the executable and are always
        # safe.
        import numpy as np
        npdt = np.dtype(dtype)
        f = lambda v: np.asarray(v, npdt)[()]
        cam = Camera(
            fx=f(cfg.fx), fy=f(cfg.fy), cx=f(cfg.cx), cy=f(cfg.cy),
            k1=f(cfg.k1), k2=f(cfg.k2), p1=f(cfg.p1), p2=f(cfg.p2),
            k3=f(cfg.k3), bf=f(cfg.bf),
            width=f(cfg.width), height=f(cfg.height),
            min_x=f(0.0), max_x=f(cfg.width), min_y=f(0.0), max_y=f(cfg.height),
        )
        if cfg.has_distortion:
            # Undistort the 4 image corners to get valid bounds
            # (Frame::ComputeImageBounds semantics, Frame.cc:434-461).
            # Computed on device, but detached to numpy before being stored
            # (see the closure-constant rule above).
            corners = jnp.array(
                [[0.0, 0.0], [cfg.width, 0.0], [0.0, cfg.height],
                 [cfg.width, cfg.height]], dtype)
            und = np.asarray(jax.jit(undistort_points)(cam, corners))
            cam = cam._replace(
                min_x=f(min(und[0, 0], und[2, 0])),
                max_x=f(max(und[1, 0], und[3, 0])),
                min_y=f(min(und[0, 1], und[1, 1])),
                max_y=f(max(und[2, 1], und[3, 1])),
            )
        return cam


# ------------------------------------------------------------- projection ----

def project(cam: Camera, pts_cam: jax.Array) -> jax.Array:
    """Camera-frame points [..., 3] → pixel coords [..., 2] (no distortion —
    the reference operates on undistorted keypoints throughout)."""
    z = pts_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pts_cam[..., 0] / zs + cam.cx
    v = cam.fy * pts_cam[..., 1] / zs + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: Camera, pts_cam: jax.Array) -> jax.Array:
    """[..., 3] → [..., 3] = (u_left, v, u_right) with u_r = u − bf/z."""
    uv = project(cam, pts_cam)
    z = jnp.where(jnp.abs(pts_cam[..., 2]) < 1e-9, 1e-9, pts_cam[..., 2])
    ur = uv[..., 0] - cam.bf / z
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def backproject(cam: Camera, uv: jax.Array, z: jax.Array) -> jax.Array:
    """Pixels [..., 2] + depth [...] → camera-frame [..., 3]
    (Frame::UnprojectStereo, Frame.cc:668)."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return jnp.stack([x, y, z], axis=-1)


def world_to_cam(Tcw: jax.Array, pts_w: jax.Array) -> jax.Array:
    return lie.transform_points(Tcw, pts_w)


def project_world(cam: Camera, Tcw: jax.Array, pts_w: jax.Array):
    """World points → (uv [...,2], depth [...])."""
    pc = world_to_cam(Tcw, pts_w)
    return project(cam, pc), pc[..., 2]


# ------------------------------------------------------------- distortion ----

def distort_normalized(cam: Camera, xy: jax.Array) -> jax.Array:
    """Apply rad-tan distortion to normalized coords [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def distort_points(cam: Camera, uv_ideal: jax.Array) -> jax.Array:
    """Ideal (undistorted) pixels → observed (distorted) pixels."""
    x = (uv_ideal[..., 0] - cam.cx) / cam.fx
    y = (uv_ideal[..., 1] - cam.cy) / cam.fy
    xy = distort_normalized(cam, jnp.stack([x, y], axis=-1))
    return jnp.stack([xy[..., 0] * cam.fx + cam.cx,
                      xy[..., 1] * cam.fy + cam.cy], axis=-1)


def undistort_points(cam: Camera, uv: jax.Array, iters: int = 10) -> jax.Array:
    """Observed pixels → ideal pixels (role of cv::undistortPoints in
    Frame::UndistortKeyPoints, Frame.cc:402).

    Gauss-Newton on the forward rad-tan model with an analytic 2×2 Jacobian —
    converges where cv2's fixed-point compensation loop drifts under strong
    distortion, and is a fixed-iteration jit-friendly loop.
    """
    xy0 = jnp.stack([(uv[..., 0] - cam.cx) / cam.fx,
                     (uv[..., 1] - cam.cy) / cam.fy], axis=-1)

    def residual(xy):
        return distort_normalized(cam, xy) - xy0

    def body(_, xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dradial_dr2 = cam.k1 + r2 * (2.0 * cam.k2 + 3.0 * r2 * cam.k3)
        # J = d distort / d xy (2×2, computed per point)
        j00 = radial + x * (2.0 * x) * dradial_dr2 + 2.0 * cam.p1 * y + 6.0 * cam.p2 * x
        j01 = x * (2.0 * y) * dradial_dr2 + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
        j10 = y * (2.0 * x) * dradial_dr2 + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
        j11 = radial + y * (2.0 * y) * dradial_dr2 + 6.0 * cam.p1 * y + 2.0 * cam.p2 * x
        r = residual(xy)
        det = j00 * j11 - j01 * j10
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        dx = (j11 * r[..., 0] - j01 * r[..., 1]) / det
        dy = (-j10 * r[..., 0] + j00 * r[..., 1]) / det
        return xy - jnp.stack([dx, dy], axis=-1)

    xy = jax.lax.fori_loop(0, iters, body, xy0)
    return jnp.stack([xy[..., 0] * cam.fx + cam.cx,
                      xy[..., 1] * cam.fy + cam.cy], axis=-1)


# ---------------------------------------------------------------- frustum ----

def in_image(cam: Camera, uv: jax.Array) -> jax.Array:
    """Inside undistorted-image bounds [..., 2] → [...] bool."""
    return ((uv[..., 0] >= cam.min_x) & (uv[..., 0] < cam.max_x) &
            (uv[..., 1] >= cam.min_y) & (uv[..., 1] < cam.max_y))


def in_frustum(cam: Camera, Tcw: jax.Array, pts_w: jax.Array,
               min_dist: jax.Array, max_dist: jax.Array,
               normal: jax.Array, view_cos_limit: float = 0.5):
    """Vectorised Frame::isInFrustum (Frame.cc:270): positive depth, in image,
    distance within the point's scale-invariance band, viewing angle within
    view_cos_limit of the point's mean viewing direction.

    Returns (visible_mask [...], uv [..., 2], ur [...], dist [...],
    view_cos [...]).
    """
    R, t = lie.mat_to_rt(Tcw)
    # Broadcast form of pts @ Rᵀ — exact f32, off the matmul-
    # precision flag (see lie.transform_points / ops/smallmat.py)
    pc = jnp.sum(pts_w[..., :, None, :] * R[..., None, :, :], axis=-1) + t
    z = pc[..., 2]
    uv = project(cam, pc)
    ur = uv[..., 0] - cam.bf / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    # camera center in world: Ow = -Rᵀt
    Ow = -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    po = pts_w - Ow
    dist = jnp.linalg.norm(po, axis=-1)
    dist_safe = jnp.where(dist < 1e-9, 1e-9, dist)
    view_cos = jnp.sum(po * normal, axis=-1) / dist_safe
    ok = ((z > 0.0) & in_image(cam, uv)
          & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos >= view_cos_limit))
    return ok, uv, ur, dist, view_cos
