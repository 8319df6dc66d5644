"""Speed-of-light accounting for the hot kernels.

For each hot program, measures device time (K-chained scans,
tools/benchmarks/device_time.py), pulls FLOPs + bytes-accessed from
XLA's compiled cost analysis, computes the roofline bound
max(flops/peak_flops, bytes/peak_bw) from the device's published peaks
(``PEAKS``, keyed by ``device_kind``), and reports the achieved fraction
of that bound.  Prints a markdown table and the rows as JSON.

The programs are f32 at "highest" matmul precision (orbslam2_tpu/
__init__.py), so the FLOP bound uses the FP32 peak.

The hot set: ORB frontend, projection matcher, local BA, GBA step — plus
the two composite steady-state programs (window tracker, fused mapping
step) whose wall share actually bounds SLAM fps.

Run: python tools/benchmarks/perf_audit.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# Published dense peaks (no sparsity) per ``jax.Device.device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, at its 700 W
# power limit; a card set to a lower limit cannot hold these clocks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    """Peaks of ``device_kind``; an unknown device is an error, never a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


def main():
    import jax
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    peaks = peaks_for(jax.devices()[0].device_kind)
    peak_flops = peaks["fp32_flops"]
    peak_bw = peaks["hbm_bytes_per_s"]
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu.models import frame as frame_mod
    from orbslam2_tpu.models import map_state as M
    from orbslam2_tpu.ops import bundle, matching
    from orbslam2_tpu.runtime import local_mapping, windowed
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.utils import camera as cam_mod
    from orbslam2_tpu.utils import synthetic
    from tools.benchmarks.device_time import measure_chained

    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=STEREO)
    cam = cam_mod.Camera.from_config(cfg.camera)

    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(40, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]
    eng = WindowedSlamEngine(cfg, enable_loop_closing=False, window=4)
    for i in range(40):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    eng.flush()
    ms = eng.ms
    N = cfg.orb.n_features_padded

    rows = []

    def cost_of(fn, *args):
        ca = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return float(ca.get("flops", 0)), float(ca.get("bytes accessed", 0))

    def add_row(name, ref, dev_s, flops, bytes_, note=""):
        t_flops = flops / peak_flops
        t_bw = bytes_ / peak_bw
        bound = max(t_flops, t_bw)
        rows.append({
            "kernel": name, "reference": ref,
            "device_ms": round(dev_s * 1e3, 2),
            "gflops": round(flops / 1e9, 2),
            "gbytes": round(bytes_ / 1e9, 3),
            "roofline_ms": round(bound * 1e3, 2),
            "bound": "HBM" if t_bw >= t_flops else "FP32",
            "pct_of_light": round(100 * bound / max(dev_s, 1e-12), 1),
        })
        print(rows[-1], flush=True)

    # ---- 1. ORB frontend (pyramid+FAST+quadtree-topk+blur+BRIEF+stereo)
    frontend = frame_mod.make_frontend_stereo(cfg)
    imgL = jnp.asarray(frames[20][0])
    imgR = jnp.asarray(frames[20][1])

    def make_fe(K):
        @jax.jit
        def run(l, r):
            def it(c, i):
                fd = frontend(l + 0.0 * c, r)
                return c + fd.xy[0, 0], fd.xy[0, 0]
            _, ys = jax.lax.scan(it, jnp.float32(0), jnp.arange(K))
            return ys
        return run
    dev_fe, _ = measure_chained(make_fe, (imgL, imgR), k=7)
    fl, by = cost_of(frontend, imgL, imgR)
    add_row("stereo ORB frontend (2x extract + stereo match)",
            "ORBextractor.cc:858 + Frame.cc:464", dev_fe, fl, by)

    # ---- 2. projection matcher [4096, 1024] ----
    C = cfg.capacity.track_candidates
    q = matching.ProjectionQuery(
        pos_w=jnp.asarray(rng.normal(0, 5, (C, 3)).astype(np.float32)
                          + np.array([0, 0, 15], np.float32)),
        normal=jnp.asarray(np.tile(np.array([0, 0, -1], np.float32),
                                   (C, 1))),
        min_dist=jnp.full((C,), 0.5, jnp.float32),
        max_dist=jnp.full((C,), 80.0, jnp.float32),
        desc=jnp.asarray(rng.integers(0, 2 ** 32, (C, 8),
                                      dtype=np.uint32)),
        valid=jnp.ones((C,), bool))
    fd = eng.last_fd

    def sbp(q_, Tcw_, fd_):
        return matching.search_by_projection(
            cam, Tcw_, q_, fd_.xy, fd_.level, fd_.desc, fd_.valid, fd_.ur,
            cfg.orb.scale_factor, cfg.orb.n_levels, radius=3.0,
            nn_ratio=2.0, check_ur=True, th_dist=matching.TH_LOW)
    Tcw = jnp.asarray(eng.last_Tcw, jnp.float32)

    def make_sbp(K):
        @jax.jit
        def run(q_, Tcw_, fd_):
            def it(c, i):
                # anti-hoist: query positions depend on the carry
                m, d, uv = sbp(q_._replace(
                    pos_w=q_.pos_w + (c * 1e-12)[None, None]), Tcw_, fd_)
                return c + d.astype(jnp.float32).sum(), d[0]
            _, ys = jax.lax.scan(it, jnp.float32(0), jnp.arange(K))
            return ys
        return run
    dev_m, _ = measure_chained(make_sbp, (q, Tcw, fd), k=9)
    fl, by = cost_of(sbp, q, Tcw, fd)
    add_row(f"projection matcher [{C}x{N}]", "ORBmatcher.cc:43,1324",
            dev_m, fl, by)

    # ---- 3. local BA (8 free + 8 fixed cams, 2048 pts, 5+10 LM) ----
    mfns = local_mapping.make_mapping_fns(cfg)
    kf = jnp.int32(eng.ref_kf)

    def make_ba(K):
        @jax.jit
        def run(m, k_):
            def it(mc, _):
                m2, n = mfns.local_ba_body(mc, k_)
                return m2, n
            m2, ys = jax.lax.scan(it, m, None, length=K)
            return ys
        return run
    dev_ba, _ = measure_chained(make_ba, (ms, kf), k=5)
    fl, by = cost_of(mfns.local_ba_body, ms, kf)
    add_row("local BA (Schur LM, 5+10 iters)", "Optimizer.cc:497",
            dev_ba, fl, by)

    # ---- 4. GBA step (all keyframes + points, one 5-iter chunk) ----
    from orbslam2_tpu.runtime.gba import GbaManager
    gman = GbaManager(cfg, use_mesh=False)
    prob = gman.build_problem(ms) if hasattr(gman, "build_problem") else None
    if prob is None:
        # build the same problem shape bundle.bundle_adjust consumes
        K_ = ms.K
        kfm = ms.kf_mp
        obs_ok = (kfm >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]
        cam_i = jnp.repeat(jnp.arange(K_, dtype=jnp.int32)[:, None], N, 1)
        sigma2 = np.array([cfg.orb.scale_factor ** (2 * l)
                           for l in range(cfg.orb.n_levels)], np.float32)
        prob = bundle.BAProblem(
            poses=ms.kf_pose, points=ms.mp_pos, point_valid=ms.mp_valid,
            cam_i=cam_i.reshape(-1),
            pt_i=jnp.where(obs_ok, kfm, 0).reshape(-1),
            uv=ms.kf_xy.reshape(-1, 2), ur=ms.kf_ur.reshape(-1),
            inv_sigma2=jnp.asarray(1.0 / sigma2)[
                ms.kf_level].reshape(-1),
            valid=obs_ok.reshape(-1))

    def gba_step(p):
        return bundle.bundle_adjust(cam, p, n_free=int(ms.K), iters_a=5,
                                    iters_b=0, solver="cg")

    def make_gba(K):
        @jax.jit
        def run(p):
            def it(c, i):
                poses, points, inlier = gba_step(
                    p._replace(poses=p.poses + c * 1e-12))
                return c + poses.sum(), poses[0, 0, 0]
            _, ys = jax.lax.scan(it, jnp.float32(0), jnp.arange(K))
            return ys
        return run
    dev_g, _ = measure_chained(make_gba, (prob,), k=3)
    fl, by = cost_of(gba_step, prob)
    add_row(f"GBA chunk ({int(ms.K)} cams, {int(ms.P)} pts, 5 LM iters, "
            "CG-Schur)", "Optimizer.cc:92 / LoopClosing.cc:679",
            dev_g, fl, by)

    # ---- 5-6. composite steady-state programs ----
    pay = tuple(np.concatenate(
        [frames[30][0].astype(np.uint8).reshape(-1),
         frames[30][1].astype(np.uint8).reshape(-1)]) for _ in range(4))
    sT = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
        np.float32))
    from tools.benchmarks import device_time as dtm
    dev_w, _ = dtm.measure_chained(
        dtm.slam_window_chain(cfg, 4),
        (ms, pay, sT, eng.last_assoc, eng.last_inlier,
         jnp.int32(eng.ref_kf)))
    tracker = windowed.make_slam_window_tracker(cfg, 4)
    fl, by = cost_of(tracker, ms, tuple(jnp.asarray(p) for p in pay), sT,
                     eng.last_assoc, eng.last_inlier, jnp.int32(eng.ref_kf))
    add_row("window tracker (4 frames: frontend+2-stage track+pose opt)",
            "Tracking.cc:366 loop", dev_w, fl, by)

    out = eng.f_track_window(ms, pay, sT, eng.last_assoc, eng.last_inlier,
                             jnp.int32(eng.ref_kf))
    zp = eng._zeros_p
    dev_map, _ = dtm.measure_chained(
        dtm.mapping_chain(cfg, 4),
        (ms, out.fds, out.assocs, out.Tcws, jnp.int32(100),
         jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
         jnp.int32(eng.frame_id), zp, zp), k=5)
    kf_step = windowed.make_window_mapping_step(cfg)
    fl, by = cost_of(
        kf_step, ms, out.fds, out.assocs, out.Tcws, jnp.int32(0),
        jnp.int32(100), jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
        jnp.int32(eng.frame_id), jnp.float32(0.0), jnp.bool_(True),
        jnp.bool_(True), zp, zp)
    add_row("fused mapping step (insert+tri+fuse+BA+cull)",
            "LocalMapping.cc:48-112", dev_map, fl, by)

    # ---- report ----
    print(f"\n{jax.devices()[0].device_kind}: roofline = max(flops / "
          f"{peak_flops / 1e12:g} TFLOP/s, bytes / {peak_bw / 1e12:g} TB/s)\n")
    print("| kernel | reference | device ms | GFLOP | GB | roofline ms | "
          "bound | % of light |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['kernel']} | {r['reference']} | {r['device_ms']} | "
              f"{r['gflops']} | {r['gbytes']} | {r['roofline_ms']} | "
              f"{r['bound']} | {r['pct_of_light']} |")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
