"""Synthetic scene generator for tests and benchmarks.

The reference's replay tests use TUM/EuRoC/KITTI datasets from disk
(SURVEY.md §4); this environment has no datasets, so we render our own:
a field of 3D "sprite" landmarks — each with a fixed, distinctive local
intensity patch — projected through the pinhole model onto frames along a
camera trajectory.  Sprites move rigidly with the world, so feature
extraction, stereo depth, tracking, BA and loop closing can all be
validated against exact ground truth.

Host-side numpy: this is a data source, not a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from orbslam2_tpu.config import CameraConfig


@dataclass
class Scene:
    points: np.ndarray        # [P, 3] world landmarks
    sprites: np.ndarray       # [P, S, S] intensity patches
    background: float


def make_scene(rng: np.random.Generator, n_points: int = 600,
               extent: Tuple[float, float, float] = (12.0, 8.0, 18.0),
               z_near: float = 4.0, sprite: int = 9) -> Scene:
    ex, ey, ez = extent
    pts = np.stack([
        rng.uniform(-ex, ex, n_points),
        rng.uniform(-ey, ey, n_points),
        rng.uniform(z_near, z_near + ez, n_points),
    ], axis=-1).astype(np.float64)
    # high-contrast random patches → strong FAST corners, distinct BRIEFs
    sprites = rng.uniform(0.0, 255.0, size=(n_points, sprite, sprite))
    sprites = np.round(sprites / 64.0) * 64.0   # quantize → sharp edges
    return Scene(points=pts, sprites=sprites.astype(np.float32),
                 background=96.0)


def look_ahead_pose(t: np.ndarray, yaw: float = 0.0, pitch: float = 0.0
                    ) -> np.ndarray:
    """World→camera SE3 for a camera at position t looking along +z."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rwc = Ry @ Rx
    Tcw = np.eye(4)
    Tcw[:3, :3] = Rwc.T
    Tcw[:3, 3] = -Rwc.T @ t
    return Tcw


def render(scene: Scene, cam: CameraConfig, Tcw: np.ndarray,
           rng: Optional[np.random.Generator] = None,
           noise: float = 2.0) -> np.ndarray:
    """Render one grayscale frame [H, W] float32."""
    h, w = cam.height, cam.width
    img = np.full((h, w), scene.background, np.float32)
    pc = scene.points @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    vis = z > 0.3
    u = cam.fx * pc[:, 0] / np.where(vis, z, 1.0) + cam.cx
    v = cam.fy * pc[:, 1] / np.where(vis, z, 1.0) + cam.cy
    s = scene.sprites.shape[1]
    r = s // 2
    order = np.argsort(-z)  # far to near: near sprites overdraw
    for i in order:
        if not vis[i]:
            continue
        # bilinear subpixel placement — integer pasting would quantize the
        # true disparity/flow to ±0.5 px and break subpixel accuracy tests
        xf, yf = u[i] - r, v[i] - r
        x0, y0 = int(np.floor(xf)), int(np.floor(yf))
        ax, ay = xf - x0, yf - y0
        if x0 < 0 or y0 < 0 or x0 + s + 1 > w or y0 + s + 1 > h:
            continue
        sp = scene.sprites[i]
        pad = np.zeros((s + 1, s + 1), np.float32)
        pad[:s, :s] += sp * (1 - ay) * (1 - ax)
        pad[:s, 1:] += sp * (1 - ay) * ax
        pad[1:, :s] += sp * ay * (1 - ax)
        pad[1:, 1:] += sp * ay * ax
        # composite over background only where the sprite has weight
        wgt = np.zeros((s + 1, s + 1), np.float32)
        wgt[:s, :s] += (1 - ay) * (1 - ax)
        wgt[:s, 1:] += (1 - ay) * ax
        wgt[1:, :s] += ay * (1 - ax)
        wgt[1:, 1:] += ay * ax
        region = img[y0:y0 + s + 1, x0:x0 + s + 1]
        img[y0:y0 + s + 1, x0:x0 + s + 1] = region * (1 - wgt) + pad
    if rng is not None and noise > 0:
        img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 255.0)


def render_stereo(scene: Scene, cam: CameraConfig, Tcw: np.ndarray,
                  rng: Optional[np.random.Generator] = None,
                  noise: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Left/right rectified pair; right camera offset by baseline along +x."""
    b = cam.baseline
    T_rl = np.eye(4)
    T_rl[0, 3] = -b          # right camera: x_r = x_l − b
    left = render(scene, cam, Tcw, rng, noise)
    right = render(scene, cam, T_rl @ Tcw, rng, noise)
    return left, right


# --------------------------------------------------------------- world ----
# Plane-based textured world: unlike the sprite scene (isolated patches on
# flat background, every descriptor footprint straddling depth
# discontinuities), surfaces carry dense locally-coherent texture — the
# statistics real ORB descriptors rely on.  Rendering is inverse-warp
# ray/plane intersection with bilinear texture sampling, so parallax,
# occlusion, and forward-motion scale change are all geometrically exact,
# and a per-pixel depth map falls out for free (RGBD).


@dataclass
class Plane:
    p0: np.ndarray        # [3] a point on the plane (texture origin)
    n: np.ndarray         # [3] unit normal (pointing toward viewers)
    eu: np.ndarray        # [3] texture u basis (unit)
    ev: np.ndarray        # [3] texture v basis (unit)
    tex: np.ndarray       # [Th, Tw] float32 intensity
    scale: float          # texture pixels per world unit
    u_range: Optional[Tuple[float, float]] = None  # finite quad bounds
    v_range: Optional[Tuple[float, float]] = None


@dataclass
class World:
    planes: List[Plane]
    background: float = 40.0


def _make_texture(rng: np.random.Generator, size: int = 512,
                  contrast: float = 70.0, base: float = 110.0,
                  persistence: float = 0.55) -> np.ndarray:
    """Multi-octave value noise: smooth large structure + sharp detail so
    FAST finds corners at every scale."""
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    octaves = [8, 32, 128, 256]
    c = 512
    while c <= size // 4:          # finer octaves for large textures
        octaves.append(c)          # (size 512 keeps the original four)
        c *= 2
    for cells in octaves:
        coarse = rng.uniform(-1.0, 1.0, (cells, cells)).astype(np.float32)
        reps = size // cells
        up = np.kron(coarse, np.ones((reps, reps), np.float32))
        tex += amp * up
        amp *= persistence
    tex = base + contrast * tex / np.abs(tex).max()
    return np.clip(tex, 0.0, 255.0)


def make_world(rng: np.random.Generator, kind: str = "corridor",
               tex_size: int = 512, tex_fn=None) -> World:
    """Textured-plane worlds.  "corridor": ground/walls/ceiling/far wall,
    depth range ~3–60 m.  "random": randomized room dimensions plus a few
    finite facade quads at varied depth/orientation — used to harvest a
    diverse vocabulary corpus.  ``tex_fn(rng)`` overrides the texture
    source (vocabulary harvesting feeds real-raster + alternative
    procedural textures here, models/vocabulary.py)."""
    def plane(p0, n, eu, scale=20.0, u_range=None, v_range=None):
        n = np.asarray(n, np.float64)
        n = n / np.linalg.norm(n)
        eu = np.asarray(eu, np.float64)
        eu = eu - n * (eu @ n)
        eu /= np.linalg.norm(eu)
        ev = np.cross(n, eu)
        tex = (tex_fn(rng) if tex_fn is not None
               else _make_texture(rng, tex_size))
        return Plane(p0=np.asarray(p0, np.float64), n=n, eu=eu, ev=ev,
                     tex=np.asarray(tex, np.float32), scale=scale,
                     u_range=u_range, v_range=v_range)

    if kind == "random":
        gy = rng.uniform(2.0, 5.0)          # ground height
        wx = rng.uniform(4.0, 10.0)         # half width
        fz = rng.uniform(30.0, 70.0)        # far wall
        planes = [
            plane([0.0, gy, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                  scale=rng.uniform(10, 30)),
            plane([-wx, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                  scale=rng.uniform(10, 30)),
            plane([wx, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                  scale=rng.uniform(10, 30)),
            plane([0.0, 0.0, fz], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                  scale=rng.uniform(10, 30)),
        ]
        for _ in range(rng.integers(1, 4)):
            # finite facade quad facing the camera at a random depth
            cx = rng.uniform(-0.6 * wx, 0.6 * wx)
            cy = rng.uniform(-1.5, 1.5)
            cz = rng.uniform(6.0, 0.7 * fz)
            half = rng.uniform(0.8, 2.5)
            yaw = rng.uniform(-0.5, 0.5)
            n = [np.sin(yaw), 0.0, -np.cos(yaw)]
            planes.append(plane([cx, cy, cz], n, [np.cos(yaw), 0.0,
                                                  np.sin(yaw)],
                                scale=rng.uniform(15, 40),
                                u_range=(-half, half),
                                v_range=(-half, half)))
        return World(planes=planes)

    planes = [
        plane([0.0, 3.5, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]),   # ground
        plane([-7.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]),   # left
        plane([7.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]),   # right
        plane([0.0, -4.5, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]),   # ceiling
        plane([0.0, 0.0, 60.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]),  # far wall
    ]
    return World(planes=planes)


def render_world(world: World, cam: CameraConfig, Tcw: np.ndarray,
                 rng: Optional[np.random.Generator] = None,
                 noise: float = 2.0, with_depth: bool = False):
    """Render [H, W] grayscale (and optional depth) by ray casting."""
    h, w = cam.height, cam.width
    Twc = np.linalg.inv(Tcw)
    C = Twc[:3, 3]
    R = Twc[:3, :3]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                      np.ones_like(u)], axis=-1)          # [H, W, 3]
    d_w = d_cam @ R.T
    best_t = np.full((h, w), np.inf)
    img = np.full((h, w), world.background, np.float32)
    depth = np.zeros((h, w), np.float32)
    for pl in world.planes:
        denom = d_w @ pl.n
        facing = denom < -1e-9          # ray runs against the normal
        t = np.where(facing, ((pl.p0 - C) @ pl.n) / np.where(
            facing, denom, -1.0), np.inf)
        hit = facing & (t > 0.05) & (t < best_t)
        if not hit.any():
            continue
        t = np.where(hit, t, 0.0)       # keep inf out of the arithmetic
        X = C[None, None, :] + t[..., None] * d_w
        rel = X - pl.p0[None, None, :]
        wu = rel @ pl.eu                # world-unit plane coordinates
        wv = rel @ pl.ev
        if pl.u_range is not None:
            hit = hit & (wu >= pl.u_range[0]) & (wu <= pl.u_range[1])
        if pl.v_range is not None:
            hit = hit & (wv >= pl.v_range[0]) & (wv <= pl.v_range[1])
        if not hit.any():
            continue
        tu = wu * pl.scale
        tv = wv * pl.scale
        Th, Tw = pl.tex.shape
        x0 = np.floor(tu).astype(np.int64)
        y0 = np.floor(tv).astype(np.int64)
        ax = (tu - x0).astype(np.float32)
        ay = (tv - y0).astype(np.float32)
        x0m, y0m = x0 % Tw, y0 % Th
        x1m, y1m = (x0 + 1) % Tw, (y0 + 1) % Th
        tex = pl.tex
        val = (tex[y0m, x0m] * (1 - ay) * (1 - ax)
               + tex[y0m, x1m] * (1 - ay) * ax
               + tex[y1m, x0m] * ay * (1 - ax)
               + tex[y1m, x1m] * ay * ax)
        img = np.where(hit, val, img)
        # depth along the camera z axis (t is along the unnormalized ray
        # whose camera-frame z component is exactly 1)
        depth = np.where(hit, t.astype(np.float32), depth)
        best_t = np.where(hit, t, best_t)
    if rng is not None and noise > 0:
        img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 255.0).astype(np.float32)
    if with_depth:
        return img, depth
    return img


def render_world_stereo(world: World, cam: CameraConfig, Tcw: np.ndarray,
                        rng: Optional[np.random.Generator] = None,
                        noise: float = 2.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    b = cam.baseline
    T_rl = np.eye(4)
    T_rl[0, 3] = -b
    left = render_world(world, cam, Tcw, rng, noise)
    right = render_world(world, cam, T_rl @ Tcw, rng, noise)
    return left, right


def straight_trajectory(n: int, step: float = 0.25,
                        start: Tuple[float, float, float] = (0, 0, 0)
                        ) -> List[np.ndarray]:
    """Forward motion along +z (KITTI-like)."""
    return [look_ahead_pose(np.asarray(start, np.float64)
                            + np.array([0, 0, step * i])) for i in range(n)]


def orbit_trajectory(n: int, radius: float = 6.0, z_center: float = 12.0,
                     frac: float = 1.0) -> List[np.ndarray]:
    """Camera circling a point cloud, yawing to keep looking at it —
    closes a loop when frac == 1."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * frac * i / n
        t = np.array([radius * np.sin(a), 0.0, z_center - radius * np.cos(a)])
        poses.append(look_ahead_pose(t, yaw=-a))
    return poses


def orbit_scene(rng, n=1000, wall_radius=12.0, z_center=10.0):
    """Cylindrical wall of sprites around the orbit center: an outward-
    looking camera sees a stable, occlusion-free texture shell from every
    angle (EuRoC-room-like geometry)."""
    scene = make_scene(rng, n)
    a = rng.uniform(0, 2 * np.pi, n)
    r = wall_radius + rng.uniform(-1.5, 1.5, n)
    pts = np.stack([r * np.sin(a), rng.uniform(-5.0, 5.0, n),
                    z_center - r * np.cos(a)], -1)
    scene.points[:] = pts
    return scene


def outward_orbit(n, radius=4.0, z_center=10.0, turns=1.0):
    """Camera circling the center while looking outward at the wall."""
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * turns * i / n
        t = np.array([radius * np.sin(a), 0.0, z_center - radius * np.cos(a)])
        poses.append(look_ahead_pose(t, yaw=np.pi + a))
    return poses


def room_world(rng: np.random.Generator, half: float = 34.0,
               tex_size: int = 512) -> World:
    """Closed rectangular room (4 inward walls + ground + ceiling), each
    plane with its own independently drawn texture — the map-scale
    circuit world: distinct appearance per wall keeps place recognition
    honest on a loop-rich tour."""
    def plane(p0, n, eu, scale=20.0):
        n = np.asarray(n, np.float64)
        n = n / np.linalg.norm(n)
        eu = np.asarray(eu, np.float64)
        eu = eu - n * (eu @ n)
        eu /= np.linalg.norm(eu)
        ev = np.cross(n, eu)
        # persistence 0.7: keep the fine octaves strong enough for FAST
        # at 5-15 m viewing distance (0.55 decays the corner-scale octave
        # to ~9% amplitude — below the detection threshold)
        return Plane(p0=np.asarray(p0, np.float64), n=n, eu=eu, ev=ev,
                     tex=np.asarray(_make_texture(rng, tex_size,
                                                  persistence=0.7),
                                    np.float32), scale=scale)

    return World(planes=[
        plane([0.0, 3.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]),   # ground
        plane([0.0, -4.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]),   # ceiling
        plane([-half, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]),  # x = −W
        plane([half, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]),  # x = +W
        plane([0.0, 0.0, -half], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]),  # z = −W
        plane([0.0, 0.0, half], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]),  # z = +W
    ])


def circuit_trajectory(n: int, half: float = 28.0, corner: float = 8.0,
                       laps: float = 1.0, yaw_out: float = 0.0,
                       pitch: float = 0.0) -> List[np.ndarray]:
    """Rounded-rectangle tour in the x-z plane (counter-clockwise), the
    camera looking along the path tangent — returns to its start after
    each lap, closing a loop late in the run (the KITTI-00-like circuit
    for the map-scale demo).

    ``yaw_out`` rotates the view toward the OUTER wall (radians; the
    forward-tangent view in a large room faces walls beyond stereo
    range — angling outward keeps near texture in frame), ``pitch``
    tilts down toward the ground."""
    a = half - corner
    L = 2.0 * a
    quarter = 0.5 * np.pi * corner
    per = 4.0 * (L + quarter)

    def at(s):
        s = s % per
        leg = s // (L + quarter)
        u = s - leg * (L + quarter)
        # leg 0 starts at (−a, −half) heading +x (yaw π/2); each leg is
        # one straight side then one quarter arc with yaw DECREASING
        phi0 = np.pi / 2 - leg * np.pi / 2
        starts = [(-a, -half), (half, -a), (a, half), (-half, a)]
        dirs = [(1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0)]
        centers = [(a, -a), (a, a), (-a, a), (-a, -a)]
        x0, z0 = starts[int(leg)]
        dx, dz = dirs[int(leg)]
        if u <= L:                                   # straight stretch
            return x0 + dx * u, z0 + dz * u, phi0
        phi = phi0 - (u - L) / corner                # quarter turn
        cx, cz = centers[int(leg)]
        return (cx + corner * np.cos(phi), cz - corner * np.sin(phi), phi)

    poses = []
    for i in range(n):
        x, z, yaw = at(per * laps * i / n)
        poses.append(look_ahead_pose(np.array([x, 0.0, z]),
                                     yaw=yaw + yaw_out, pitch=pitch))
    return poses
