"""Benchmark: frame throughput on one GPU, SLAM and LOC modes.

Prints the device identity (as chip_smoke.py does), then ONE JSON line
{"metric", "value", "unit", "vs_baseline", ...}.  Exits non-zero when JAX
finds no GPU.

Every mode reports BOTH:

  * wall fps — median of 3 back-to-back measured passes (best-of is also
    published, labelled as such);
  * device fps — per-program device time estimated by K-chained scans
    (tools/benchmarks/device_time.py): t(K) = overhead + K·device, so
    differencing K=1 and K=9 removes the per-call host overhead.

Mode legs mirror the reference benchmark matrix
(Tools/Benchmarks/executeBenchmarks.sh: SLAM + LOC per sensor):
  * stereo SLAM (windowed engine, window=4 — full pipeline incl.
    keyframe insertion, triangulation, fuse, local BA, culling, loop
    detection)
  * stereo LOC (streaming windows)
  * mono SLAM (windowed; H/F bootstrap then windowed tracking)
  * oracle leg: ATE of the engine vs the cv2-only mini-SLAM
    (tools/benchmarks/proxy_slam.py) on the same rendered sequence — a
    CPU cross-check, skipped with a printed line when cv2 is missing.

vs_baseline: the measured reference proxy (tools/benchmarks/
reference_proxy.py — cv2-native ORB tracking loop, see BASELINE.md).
Falls back to the 30 fps camera-rate claim if the proxy json is missing.
"""

import json
import os
import sys
import time

import numpy as np

CAMERA_RATE_FPS = 30.0  # fastest camera config in the reference repo
WINDOW = 8              # frames per LOC-mode device program
SLAM_WINDOW = 4         # frames per SLAM-mode device program
N_WINDOWS = 24
WARMUP_FRAMES = 28      # past the first KF-culling program variant
MEASURE_FRAMES = 48


def _reference_fps():
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "tools", "benchmarks", "reference_proxy.json")
    try:
        with open(p) as f:
            return float(json.load(f)["value"]), "measured cv2 proxy"
    except Exception:
        return CAMERA_RATE_FPS, "camera-rate claim"


def _median(xs):
    return float(np.median(xs))


_T0 = time.perf_counter()


def _progress(leg):
    """One stderr line per finished leg, so a cut run shows how far it got."""
    print(f"bench: {leg} done at {time.perf_counter() - _T0:.1f} s",
          file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import print_identity, require_gpus
    require_gpus(1)
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print_identity()
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     MONOCULAR, OrbConfig, STEREO,
                                     SlamConfig)
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.runtime import streaming
    from orbslam2_tpu.utils import synthetic
    from tools.benchmarks import device_time as dtm

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
    n_frames = WARMUP_FRAMES + 3 * MEASURE_FRAMES
    poses = synthetic.straight_trajectory(n_frames, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]

    # ---- SLAM mode: windowed engine, steady state after warm-up ----
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True,
                             window=SLAM_WINDOW)
    eng.prewarm()    # compile EVERY program variant incl. the per-frame
    #                  fallback + reloc paths (a LOST window otherwise
    #                  compiles them mid-measurement)
    for i in range(WARMUP_FRAMES):                 # compiles + map bootstrap
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    pass_fps = []
    kf_counts = []
    start = WARMUP_FRAMES
    for _ in range(3):
        kf_before = eng.stats["kf_inserted"]
        t0 = time.perf_counter()
        for i in range(start, start + MEASURE_FRAMES):
            eng.track_stereo(*frames[i], timestamp=0.1 * i)
        eng.flush()      # drain the in-flight window + deferred mapping
        pass_fps.append(MEASURE_FRAMES / (time.perf_counter() - t0))
        kf_counts.append(eng.stats["kf_inserted"] - kf_before)
        start += MEASURE_FRAMES
    slam_fps = _median(pass_fps)                 # the headline (median)
    kf_per_frame = float(np.median(kf_counts)) / MEASURE_FRAMES

    _progress("stereo SLAM")

    # ---- device-time evidence on the LIVE engine state ----
    pay1 = np.concatenate(
        [frames[40][0].astype(np.uint8).reshape(-1),
         frames[40][1].astype(np.uint8).reshape(-1)])
    payw = tuple(pay1 for _ in range(SLAM_WINDOW))
    sT = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
        np.float32))
    dev_w, _ = dtm.measure_chained(
        dtm.slam_window_chain(cfg, SLAM_WINDOW),
        (eng.ms, payw, sT, eng.last_assoc, eng.last_inlier,
         jnp.int32(eng.ref_kf)))
    out = eng.f_track_window(eng.ms, payw, sT, eng.last_assoc,
                             eng.last_inlier, jnp.int32(eng.ref_kf))
    zp = eng._zeros_p
    dev_m, _ = dtm.measure_chained(
        dtm.mapping_chain(cfg, SLAM_WINDOW),
        (eng.ms, out.fds, out.assocs, out.Tcws, jnp.int32(100),
         jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
         jnp.int32(eng.frame_id), zp, zp), k=5)
    dev_d, _ = dtm.measure_chained(
        dtm.detect_chain(cfg, eng.loop_closer.voc),
        (eng.ms, eng.loop_closer.db, jnp.int32(eng.ref_kf)), k=5)
    per_frame = dev_w / SLAM_WINDOW + kf_per_frame * (dev_m + dev_d)
    device = {
        "slam_device_ms_per_frame": round(dev_w / SLAM_WINDOW * 1e3, 2),
        "mapping_device_ms_per_kf": round(dev_m * 1e3, 2),
        "detect_device_ms_per_kf": round(dev_d * 1e3, 2),
        "slam_device_limit_fps": round(1.0 / per_frame, 2),
    }

    _progress("device time")

    # ---- LOC mode: streaming windows, pipelined uint8 uploads ----
    track_window = streaming.make_window_tracker(cfg, WINDOW)
    win_frames = [(frames[WARMUP_FRAMES + i % WINDOW][0].astype(np.uint8),
                   frames[WARMUP_FRAMES + i % WINDOW][1].astype(np.uint8))
                  for i in range(WINDOW)]
    flat = streaming.pack_window_uint8(win_frames)

    vel_inv = (np.linalg.inv(eng.velocity) if eng.velocity is not None
               else np.eye(4, dtype=np.float32))
    state_T = jnp.asarray(np.stack([
        eng.last_Tcw.astype(np.float32),
        (vel_inv @ eng.last_Tcw).astype(np.float32)]))
    assoc = eng.last_assoc
    ref_kf = jnp.int32(eng.ref_kf)
    ms = eng.ms

    dev = jax.device_put(flat)
    res = track_window(ms, dev, state_T, assoc, ref_kf)   # warm compile
    jax.block_until_ready(res.summaries)

    loc_rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        dev = jax.device_put(flat)
        res = track_window(ms, dev, state_T, assoc, ref_kf)
        for _ in range(N_WINDOWS - 1):
            dev = jax.device_put(flat)      # async H2D overlaps compute
            res = track_window(ms, dev, res.state_T, res.assoc, ref_kf)
        np.asarray(res.summaries)           # final sync + fetch
        loc_rates.append((WINDOW * N_WINDOWS) / (time.perf_counter() - t0))
    loc_fps = _median(loc_rates)
    dev_l, _ = dtm.measure_chained(
        dtm.loc_window_chain(cfg, WINDOW),
        (ms, jnp.asarray(flat), state_T, assoc, ref_kf))
    device["loc_device_limit_fps"] = round(WINDOW / dev_l, 2)

    _progress("LOC")

    # ---- mono SLAM leg (VERDICT r4 weak #7: bench matrix was
    # stereo-only; reference regression set includes mono EuRoC) ----
    # sideways-dominant motion: mono H/F bootstrap needs parallax
    # (pure forward motion is init-degenerate; test_mono.py pattern)
    n_m = WARMUP_FRAMES + 2 * MEASURE_FRAMES
    poses_m = [synthetic.look_ahead_pose(
        np.array([0.18 * i, 0.0, 0.04 * i])) for i in range(n_m)]
    frames_m = [synthetic.render_world(world, cfg.camera, T, rng,
                                       noise=1.0) for T in poses_m]
    cfg_m = cfg.replace(sensor=MONOCULAR)
    eng_m = WindowedSlamEngine(cfg_m, enable_loop_closing=True,
                               window=SLAM_WINDOW)
    eng_m.prewarm()
    for i in range(WARMUP_FRAMES):
        eng_m.track_monocular(frames_m[i], timestamp=0.1 * i)
    mono_pass = []
    for p in range(2):
        t0 = time.perf_counter()
        for i in range(WARMUP_FRAMES + p * MEASURE_FRAMES,
                       WARMUP_FRAMES + (p + 1) * MEASURE_FRAMES):
            eng_m.track_monocular(frames_m[i], timestamp=0.1 * i)
        eng_m.flush()
        mono_pass.append(MEASURE_FRAMES / (time.perf_counter() - t0))
    mono = {
        "mono_slam_fps": round(_median(mono_pass), 2),
        "mono_pass_fps": [round(f, 2) for f in mono_pass],
        "mono_kf_per_frame": round(
            eng_m.stats["kf_inserted"] / n_m, 3),
    }

    _progress("mono SLAM")

    # ---- independent oracle leg: engine ATE vs cv2 mini-SLAM ATE on
    # the same frames (no alignment: stereo scale is metric) ----
    oracle = None
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("oracle leg skipped: cv2 is not importable", flush=True)
    else:
        from tools.benchmarks.proxy_slam import run_proxy_slam

        def ate(poses_est, poses_gt):
            errs = []
            for Te, Tg in zip(poses_est, poses_gt):
                if Te is None:
                    continue
                Ce = -Te[:3, :3].T @ Te[:3, 3]
                Cg = -Tg[:3, :3].T @ Tg[:3, 3]
                errs.append(np.sum((Ce - Cg) ** 2))
            return float(np.sqrt(np.mean(errs))) if errs else float("nan")

        n_o = WARMUP_FRAMES + MEASURE_FRAMES
        repo_poses = eng.frame_poses()[:n_o]
        repo_ate = ate(repo_poses, poses[:n_o])
        u8 = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r in frames[:n_o]]
        proxy_poses = run_proxy_slam(u8, cfg.camera)
        proxy_ate = ate(proxy_poses, poses[:n_o])
        oracle = {
            "oracle_repo_ate_m": round(repo_ate, 4),
            "oracle_cv2proxy_ate_m": round(proxy_ate, 4),
            "oracle_repo_beats_proxy": bool(repo_ate <= proxy_ate),
        }

    # ---- distributed-BA scaling efficiency (multi-device hosts only) ----
    scaling = None
    if jax.device_count() >= 2:
        from tools.benchmarks.scaling import measure_scaling
        scaling = measure_scaling()

    ref_fps, ref_src = _reference_fps()
    out = {
        "metric": "slam_mode_fps_per_chip",
        "value": round(slam_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(slam_fps / ref_fps, 3),
        "headline_is": "median of 3 passes",
        "baseline_fps": ref_fps,
        "baseline_source": ref_src,
        "slam_kf_per_frame": round(kf_per_frame, 3),
        "slam_pass_fps": [round(f, 2) for f in pass_fps],
        "slam_best_fps": round(max(pass_fps), 2),
        "loc_mode_fps": round(loc_fps, 2),
        "loc_pass_fps": [round(f, 2) for f in loc_rates],
        "loc_vs_baseline": round(loc_fps / ref_fps, 3),
        "vs_camera_rate": round(slam_fps / CAMERA_RATE_FPS, 3),
    }
    out.update(device)
    out.update(mono)
    if oracle is not None:
        out.update(oracle)
    if scaling is not None:
        out.update(scaling)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
