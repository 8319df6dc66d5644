"""Probe: device-time attribution inside the fused mapping step.

The windowed-phase probe put the mapping program at ~89 ms/keyframe of
device time — the single biggest lever on SLAM-mode fps (at 0.25
kf/frame it costs more per frame than tracking itself).  This probe
times the program with stages toggled (do_ba / do_cull are runtime
flags; triangulation and fuse are ablated by rebuilding the step) to
attribute the cost, plus the LOC window for the r3→r4 regression check.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(window=4):
    import jax
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.runtime.windowed import (WindowedSlamEngine,
                                               make_window_mapping_step)
    from orbslam2_tpu.runtime import streaming
    from orbslam2_tpu.utils import synthetic
    from tools.benchmarks import device_time as dt

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
    poses = synthetic.straight_trajectory(40, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]

    eng = WindowedSlamEngine(cfg, enable_loop_closing=False, window=window)
    for i in range(40):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    eng.flush()
    print(f"map: {eng.n_kfs} KFs, {eng.n_live_points} pts", flush=True)

    ms = eng.ms
    N = cfg.orb.n_features_padded
    pay = eng._window_payload(
        [(np.concatenate([frames[36][0].astype(np.uint8).reshape(-1),
                          frames[36][1].astype(np.uint8).reshape(-1)]), 0.0)
         for _ in range(window)])
    assoc = eng.last_assoc
    inl = eng.last_inlier
    sT = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
        np.float32))
    out = eng.f_track_window(ms, pay, sT, assoc, inl, jnp.int32(eng.ref_kf))
    jax.block_until_ready(out.summaries)
    zp = eng._zeros_p

    def measure_mapping(do_ba, do_cull, label):
        kf_step = make_window_mapping_step(cfg)

        def make(K):
            @jax.jit
            def run(ms_, fds, assocs, Tcws, slot0, ord0, parent, fid,
                    vis, fnd):
                def body(c, i):
                    ms_c, slot, ordn = c
                    ms2, stats = kf_step(
                        ms_c, fds, assocs, Tcws, jnp.int32(0), slot, ordn,
                        parent, fid + i, jnp.float32(0.0),
                        jnp.bool_(do_ba), jnp.bool_(do_cull), vis, fnd)
                    return (ms2, slot + 1, ordn + 1), stats[0]
                _, ys = jax.lax.scan(body, (ms_, slot0, ord0),
                                     jnp.arange(K))
                return ys
            return run

        dev, oh = dt.measure_chained(
            make, (ms, out.fds, out.assocs, out.Tcws, jnp.int32(100),
                   jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
                   jnp.int32(eng.frame_id), zp, zp), k=5)
        print(f"  mapping[{label:12s}] {dev*1e3:8.2f} ms/kf "
              f"(overhead {oh*1e3:.1f} ms)", flush=True)
        return dev

    print("== mapping-step ablation (device ms per keyframe)")
    full = measure_mapping(True, True, "full")
    no_cull = measure_mapping(True, False, "no_cull")
    no_ba = measure_mapping(False, True, "no_ba")
    neither = measure_mapping(False, False, "insert+tri")
    print(f"  => BA ~{(full-no_ba)*1e3:.1f} ms, cull ~"
          f"{(full-no_cull)*1e3:.1f} ms, insert+tri+fuse ~"
          f"{neither*1e3:.1f} ms")

    # ---- LOC window device time ----
    print("== LOC window (streaming, window=8)")
    W = 8
    win_frames = [(frames[20 + i % W][0].astype(np.uint8),
                   frames[20 + i % W][1].astype(np.uint8))
                  for i in range(W)]
    flat = streaming.pack_window_uint8(win_frames)
    sT2 = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
        np.float32))
    dev, oh = dt.measure_chained(
        dt.loc_window_chain(cfg, W),
        (ms, jnp.asarray(flat), sT2, eng.last_assoc, jnp.int32(eng.ref_kf)))
    print(f"  loc_window[8]: {dev*1e3:8.2f} ms/window "
          f"({dev/W*1e3:.2f} ms/frame, {W/dev:.1f} fps device-limit), "
          f"overhead {oh*1e3:.1f} ms")


if __name__ == "__main__":
    main()
