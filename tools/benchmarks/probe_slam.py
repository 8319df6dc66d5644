"""Probe: steady-state SLAM-mode timing + keyframe-decision internals.

Runs the synchronous engine over a synthetic stereo sequence and prints
per-frame timing plus the NeedNewKeyFrame inputs, so keyframe-cadence /
throughput pathologies are visible (VERDICT r2 weak #1/#2).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.runtime.slam import SlamEngine
    from orbslam2_tpu.runtime import tracking
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
    n_frames = 48
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]

    eng = SlamEngine(cfg, enable_loop_closing=False)

    records = []
    for i, (L, R) in enumerate(frames):
        kf_before = eng.stats["kf_inserted"]
        t0 = time.perf_counter()
        eng.track_stereo(L, R, 0.1 * i)
        dt = (time.perf_counter() - t0) * 1e3
        rec = dict(i=i, ms=round(dt, 1),
                   kf=eng.stats["kf_inserted"] - kf_before,
                   state=eng.state, n_kfs=eng.n_kfs,
                   live_pts=eng.n_live_points)
        records.append(rec)
        print(rec, flush=True)

    warm = [r["ms"] for r in records[16:]]
    kfs = sum(r["kf"] for r in records[16:])
    print(json.dumps({
        "steady_fps": round(1e3 * len(warm) / sum(warm), 2),
        "mean_ms": round(float(np.mean(warm)), 1),
        "kf_per_frame": round(kfs / len(warm), 2),
        "stats": eng.stats,
    }))


if __name__ == "__main__":
    main()
