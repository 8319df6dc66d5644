"""Instrument the windowed engine's per-window phases at bench shapes.

Wraps the engine's _dispatch_window / _retire_pending /
_create_window_keyframe / loop-closer calls with wall timers to find
where the bench's ~825 ms/window goes when device programs only account
for ~154 ms.
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
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
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
    n_frames = 76
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]

    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    eng.prewarm()

    acc = {}

    def wrap(obj, name):
        orig = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0)
            acc[name + "_n"] = acc.get(name + "_n", 0) + 1
            return out

        setattr(obj, name, timed)

    # class-level wrap: super()._track_common calls resolve via the
    # class, not the instance, so instance wrappers miss them
    from orbslam2_tpu.runtime import slam as slam_mod
    orig_tc = slam_mod.SlamEngine._track_common

    def timed_tc(self, pay, ts):
        t0 = time.perf_counter()
        out = orig_tc(self, pay, ts)
        acc["per_frame_fallback"] = acc.get("per_frame_fallback", 0.0) + (
            time.perf_counter() - t0)
        acc["per_frame_fallback_n"] = acc.get("per_frame_fallback_n", 0) + 1
        return out

    slam_mod.SlamEngine._track_common = timed_tc

    orig_lost = slam_mod.SlamEngine._handle_lost

    def timed_lost(self, fd, ts):
        t0 = time.perf_counter()
        out = orig_lost(self, fd, ts)
        acc["handle_lost"] = acc.get("handle_lost", 0.0) + (
            time.perf_counter() - t0)
        acc["handle_lost_n"] = acc.get("handle_lost_n", 0) + 1
        return out

    slam_mod.SlamEngine._handle_lost = timed_lost

    wrap(eng, "_dispatch_window")
    wrap(eng, "_retire_pending")
    wrap(eng, "_create_window_keyframe")
    wrap(eng.loop_closer, "on_keyframe_deferred")
    wrap(eng.loop_closer, "poll_deferred")
    wrap(eng.loop_closer.gba, "poll_and_merge")

    for i in range(28):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    acc.clear()

    t0 = time.perf_counter()
    for i in range(28, n_frames):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    eng.flush()
    total = time.perf_counter() - t0
    n_meas = n_frames - 28
    print(f"measured {n_meas} frames in {total:.3f}s "
          f"= {n_meas/total:.2f} fps, kf={eng.stats['kf_inserted']}")
    for k in sorted(acc):
        if k.endswith("_n"):
            continue
        print(f"  {k:28s} {acc[k]*1e3:9.1f} ms total "
              f"({acc[k]/max(acc.get(k+'_n',1),1)*1e3:7.1f} ms/call × "
              f"{acc.get(k+'_n', 0)})")


if __name__ == "__main__":
    main()
