"""Independent end-to-end oracle: the repo engine vs a cv2-only mini-SLAM
on the SAME rendered sequences (VERDICT r4 missing #1).

The cv2 loop (tools/benchmarks/proxy_slam.py) shares no code with the
JAX engine — ORB extraction, matching, PnP and triangulation are all
OpenCV's native C++ kernels, the same stack the reference links.  Both
consume identical frames from utils/synthetic.py; each is scored against
ground truth independently.  Agreement from two unrelated
implementations rules out a renderer/tracker convention bias (projection
handedness, distortion sign) that a self-graded test could hide.

Acceptance per VERDICT r4 next #3: repo ATE <= proxy ATE on every leg
(straight, orbit, loop circuit) — the engine with local BA must beat a
PnP-odometry loop with no BA.
"""

import numpy as np
import pytest

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.utils import synthetic, trajectory

cv2 = pytest.importorskip("cv2")


def make_cfg():
    return SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=800),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)


def _ate(poses_est, poses_gt):
    """ATE RMSE without alignment (stereo: true scale, starts at
    identity) over the frames both tracked."""
    errs = []
    for Te, Tg in zip(poses_est, poses_gt):
        if Te is None:
            continue
        Ce = -Te[:3, :3].T @ Te[:3, 3]
        Cg = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.sum((Ce - Cg) ** 2))
    assert errs
    return float(np.sqrt(np.mean(errs))), len(errs)


def _run_leg(frames, poses_gt, cfg, rng, enable_loop_closing=False,
             **proxy_kw):
    from orbslam2_tpu.runtime.slam import SlamEngine
    from tools.benchmarks.proxy_slam import run_proxy_slam

    # both systems anchor their world at camera 0 — rebase gt to match
    T0inv = np.linalg.inv(poses_gt[0])
    poses_gt = [T @ T0inv for T in poses_gt]
    u8 = [(l.astype(np.uint8), r.astype(np.uint8)) for l, r in frames]

    eng = SlamEngine(cfg, enable_loop_closing=enable_loop_closing)
    for i, (l, r) in enumerate(frames):
        eng.track_stereo(l, r, timestamp=0.1 * i)
    repo_poses = eng.frame_poses()
    repo_tracked = sum(p is not None for p in repo_poses)

    proxy_poses = run_proxy_slam(u8, cfg.camera, **proxy_kw)
    proxy_tracked = sum(p is not None for p in proxy_poses)

    n = len(poses_gt)
    assert repo_tracked >= 0.95 * n, (repo_tracked, n, eng.stats)
    # the proxy is deliberately the weaker system (no BA, no reloc);
    # it must merely stay mostly on track to serve as a cross-check
    assert proxy_tracked >= 0.75 * n, (proxy_tracked, n)
    repo_ate, _ = _ate(repo_poses, poses_gt)
    proxy_ate, _ = _ate(proxy_poses, poses_gt)
    return repo_ate, proxy_ate


def _wall_orbit_frames(rng, cfg, n, turns):
    """Outward-looking orbit inside a cylindrical sprite wall — the
    synthetic.orbit_scene geometry (stable, occlusion-free from every
    angle); turns=1 closes the loop."""
    scene = synthetic.orbit_scene(rng, n=1400)
    poses_gt = synthetic.outward_orbit(n, radius=4.0, z_center=10.0,
                                       turns=turns)
    frames = [synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
              for T in poses_gt]
    return frames, poses_gt


def test_oracle_straight(rng):
    """Fast leg: forward corridor motion, engine vs cv2 oracle."""
    cfg = make_cfg()
    world = synthetic.make_world(rng)
    poses_gt = synthetic.straight_trajectory(36, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses_gt]
    repo_ate, proxy_ate = _run_leg(frames, poses_gt, cfg, rng)
    # both must independently agree with ground truth...
    assert repo_ate < 0.15, repo_ate
    assert proxy_ate < 0.5, proxy_ate
    # ...and the BA-corrected engine must not lose to a no-BA PnP loop
    assert repo_ate <= proxy_ate, (repo_ate, proxy_ate)


@pytest.mark.slow
def test_oracle_orbit(rng):
    cfg = make_cfg()
    frames, poses_gt = _wall_orbit_frames(rng, cfg, 72, turns=0.5)
    repo_ate, proxy_ate = _run_leg(frames, poses_gt, cfg, rng,
                                   kf_every=2)
    assert repo_ate < 0.5, repo_ate
    assert proxy_ate < 2.0, proxy_ate
    assert repo_ate <= proxy_ate, (repo_ate, proxy_ate)


@pytest.mark.slow
def test_oracle_loop_circuit(rng):
    """Full orbit closing a loop; loop closing enabled on the engine."""
    cfg = make_cfg()
    frames, poses_gt = _wall_orbit_frames(rng, cfg, 120, turns=1.0)
    repo_ate, proxy_ate = _run_leg(frames, poses_gt, cfg, rng,
                                   enable_loop_closing=True, kf_every=2)
    assert repo_ate < 0.5, repo_ate
    assert proxy_ate < 3.0, proxy_ate
    assert repo_ate <= proxy_ate, (repo_ate, proxy_ate)
