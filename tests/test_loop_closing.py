"""Loop closing + relocalization, end-to-end on synthetic sequences."""

import numpy as np
import pytest

from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                 STEREO, SlamConfig)
from orbslam2_tpu.models import vocabulary as voc_mod
from orbslam2_tpu.runtime import tracking
from orbslam2_tpu.runtime.slam import SlamEngine
from orbslam2_tpu.utils import synthetic


def make_cfg():
    return SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=600),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)


@pytest.mark.slow
def test_relocalization_after_lost(rng):
    cfg = make_cfg()
    voc = voc_mod.default_vocabulary()
    scene = synthetic.make_scene(rng, 900, extent=(14.0, 9.0, 40.0),
                                 z_near=3.0)
    poses_gt = synthetic.straight_trajectory(10, step=0.25)
    eng = SlamEngine(cfg, vocabulary=voc)
    for i, T in enumerate(poses_gt):
        l, r = synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
        eng.track_stereo(l, r, 0.1 * i)
    assert eng.state == tracking.OK

    # kidnap: declare the tracker lost, then show it a view from early in
    # the trajectory — relocalization must recover the pose
    eng.state = tracking.LOST
    eng.velocity = None
    T_back = poses_gt[2]
    l, r = synthetic.render_stereo(scene, cfg.camera, T_back, rng, 1.0)
    Tcw = eng.track_stereo(l, r, 99.0)
    assert Tcw is not None, "relocalization failed"
    assert eng.stats["reloc"] == 1
    Ce = -Tcw[:3, :3].T @ Tcw[:3, 3]
    Cg = -T_back[:3, :3].T @ T_back[:3, 3]
    assert np.linalg.norm(Ce - Cg) < 0.1, (Ce, Cg)


@pytest.mark.slow
def test_loop_closing_orbit(rng):
    cfg = make_cfg()
    voc = voc_mod.default_vocabulary()
    scene = synthetic.orbit_scene(rng)
    # 1.25 turns: the consistency check needs several consecutive keyframes
    # after the first revisit (LoopClosing.cc:188-248 semantics)
    n_frames = 72
    poses_gt = synthetic.outward_orbit(n_frames, radius=4.0, z_center=10.0,
                                       turns=1.25)
    eng = SlamEngine(cfg, vocabulary=voc)
    tracked = 0
    for i, T in enumerate(poses_gt):
        l, r = synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
        out = eng.track_stereo(l, r, 0.1 * i)
        tracked += out is not None
    assert tracked > n_frames * 0.85, (tracked, eng.stats)
    # the orbit returns to its start: the loop must be detected and closed
    assert eng.stats["loops_closed"] >= 1, eng.stats
    eng.finish_gba()   # drain the background global BA before judging ATE

    poses_est = eng.frame_poses()
    errs = []
    for Te, Tg in zip(poses_est, poses_gt):
        if Te is None:
            continue
        # the engine's world frame is the first camera: rebase into gt world
        Te = Te @ poses_gt[0]
        Ce = -Te[:3, :3].T @ Te[:3, 3]
        Cg = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.linalg.norm(Ce - Cg))
    errs = np.asarray(errs)
    # ~25 m travelled around the circle; after loop closure the trajectory
    # should be globally consistent
    assert np.sqrt((errs ** 2).mean()) < 0.5, (errs.max(), eng.stats)
