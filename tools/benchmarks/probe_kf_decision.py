"""Probe: log NeedNewKeyFrame inputs per frame + time mapping-step parts.

Diagnoses keyframe cadence (why kf-per-frame?) and the mapping-step cost
breakdown on the real chip.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.runtime.slam import SlamEngine
    from orbslam2_tpu.utils import synthetic

    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)

    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    n_frames = 40
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]

    eng = SlamEngine(cfg, enable_loop_closing=False)

    orig = eng._need_new_keyframe

    def spy(sm):
        r = orig(sm)
        ref_m = max(sm.ref_tracked3 if eng.kf_ordinal > 2
                    else sm.ref_tracked2, 1)
        print(f"  kfdec: inl={sm.n_inliers_map} refm={ref_m} "
              f"th={0.75 * ref_m:.0f} tc={sm.n_tracked_close} "
              f"ntc={sm.n_nontracked_close} "
              f"since={eng.frame_id - eng.last_kf_frame_id} -> {r}",
              flush=True)
        return r
    eng._need_new_keyframe = spy

    for i, (L, R) in enumerate(frames):
        t0 = time.perf_counter()
        eng.track_stereo(L, R, 0.1 * i)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"frame {i}: {dt:.0f} ms kfs={eng.n_kfs} "
              f"pts={eng.n_live_points}", flush=True)


if __name__ == "__main__":
    main()
