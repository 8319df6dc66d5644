"""Per-dispatch profiling of the SLAM-mode window pipeline on the GPU.

Times each device program separately at steady state (bench shapes):
  track_window, mapping_step (and its sub-stages via split programs),
  detect_step (and its sub-stages).

Run: python tools/benchmarks/profile_slam.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def timeit(fn, *args, n=10, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1000.0  # ms


def main():
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.models import map_state as M
    from orbslam2_tpu.runtime import local_mapping, tracking
    from orbslam2_tpu.runtime.windowed import (WindowedSlamEngine,
                                               make_slam_window_tracker)
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

    W = 4
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=W)
    eng.loop_closer.prewarm(eng.ms)
    for i in range(n_frames):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    eng.flush()
    print(f"warmed: {eng.stats}", file=sys.stderr)

    ms = eng.ms
    res = {}

    # ---- track_window ----
    pay = np.concatenate([
        np.ascontiguousarray(frames[i % n_frames][0], dtype=np.uint8
                             ).reshape(-1)
        for pair in range(W) for i in (2 * pair, 2 * pair + 1)])
    state_T = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]
                                   ).astype(np.float32))
    f_track = eng.f_track_window
    res["track_window_ms"] = timeit(
        f_track, ms, pay, state_T, eng.last_assoc, eng.last_inlier,
        jnp.int32(eng.ref_kf))

    # ---- mapping_step full ----
    out = f_track(ms, pay, state_T, eng.last_assoc, eng.last_inlier,
                  jnp.int32(eng.ref_kf))
    jax.block_until_ready(out.summaries)
    zeros = jnp.zeros((ms.P,), jnp.int32)
    kf_slot = int(np.argmin(np.asarray(ms.kf_valid)))  # a free slot
    args = (ms, out.fds, out.assocs, out.Tcws, jnp.int32(1),
            jnp.int32(kf_slot), jnp.int32(eng.kf_ordinal),
            jnp.int32(eng.ref_kf), jnp.int32(eng.frame_id),
            jnp.float32(1.0), jnp.bool_(True), jnp.bool_(True),
            zeros, zeros)
    res["mapping_step_ms"] = timeit(lambda *a: eng.f_window_kf(*a)[1], *args)

    # ---- mapping sub-stages (separate jits over the same state) ----
    tfns = tracking.make_tracking_fns(cfg)
    mfns = local_mapping.make_mapping_fns(cfg)
    from orbslam2_tpu.ops import triangulate as tri_mod
    tri_between, insert_tri = tri_mod.make_triangulation_bodies(cfg)

    fd = jax.tree_util.tree_map(lambda x: x[1], out.fds)
    Tcw1 = out.Tcws[1]
    assoc1 = out.assocs[1]

    f_insert = jax.jit(tfns.insert_keyframe_body)
    ms_ins, _ = f_insert(ms, fd, Tcw1, assoc1, jnp.int32(kf_slot),
                         jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
                         jnp.int32(eng.frame_id), jnp.float32(1.0))
    jax.block_until_ready(ms_ins.kf_pose)
    res["sub_insert_kf_ms"] = timeit(
        lambda: f_insert(ms, fd, Tcw1, assoc1, jnp.int32(kf_slot),
                         jnp.int32(eng.kf_ordinal), jnp.int32(eng.ref_kf),
                         jnp.int32(eng.frame_id), jnp.float32(1.0))[0].kf_pose)

    f_cullmp = jax.jit(mfns.cull_map_points_body)
    res["sub_cull_mp_ms"] = timeit(
        lambda: f_cullmp(ms_ins, jnp.int32(eng.kf_ordinal))[0].mp_valid)

    # triangulation: TRI_NB vmapped tri_between + sequential inserts
    TRI_NB = 10

    @jax.jit
    def tri_only(ms_):
        w = M.covisibility_row(ms_, jnp.int32(kf_slot))
        topw, topi = jax.lax.top_k(w, TRI_NB)
        tris = jax.vmap(lambda nb: tri_between(ms_, jnp.int32(kf_slot), nb)
                        )(topi)
        return tris.ok.sum()

    res["sub_triangulate_match_ms"] = timeit(tri_only, ms_ins)

    @jax.jit
    def tri_full(ms_):
        w = M.covisibility_row(ms_, jnp.int32(kf_slot))
        topw, topi = jax.lax.top_k(w, TRI_NB)
        tris = jax.vmap(lambda nb: tri_between(ms_, jnp.int32(kf_slot), nb)
                        )(topi)

        def tri_iter(i, carry):
            ms2, n_ = carry
            tri = jax.tree_util.tree_map(lambda x: x[i], tris)
            free1 = ms2.kf_mp[kf_slot] < 0
            tri = tri._replace(ok=tri.ok & free1 & (topw[i] >= 15))
            ms2, n_ins = insert_tri(ms2, jnp.int32(kf_slot), topi[i], tri,
                                    jnp.int32(eng.kf_ordinal))
            return ms2, n_ + n_ins

        ms2, n = jax.lax.fori_loop(0, TRI_NB, tri_iter,
                                   (ms_, jnp.int32(0)))
        return ms2.mp_valid.sum() + n

    res["sub_triangulate_full_ms"] = timeit(tri_full, ms_ins)

    f_fuse = jax.jit(mfns.fuse_into_kf_body)
    res["sub_fuse_ms"] = timeit(
        lambda: f_fuse(ms_ins, jnp.int32(kf_slot))[0].mp_valid)

    f_ba = jax.jit(mfns.local_ba_body)
    res["sub_local_ba_ms"] = timeit(
        lambda: f_ba(ms_ins, jnp.int32(kf_slot))[0].kf_pose)

    f_cullkf = jax.jit(mfns.cull_keyframes_body)
    res["sub_cull_kf_ms"] = timeit(
        lambda: f_cullkf(ms_ins, jnp.int32(kf_slot))[0].kf_valid)

    # ---- detect_step ----
    lc = eng.loop_closer
    res["detect_step_ms"] = timeit(
        lambda: lc.f_detect_step(ms, lc.db, jnp.int32(kf_slot))[2])

    # detect sub-stages
    from orbslam2_tpu.ops import bow as bow_mod
    voc = lc.voc

    @jax.jit
    def bow_only(ms_):
        return bow_mod.bow_vector(voc, ms_.kf_desc[kf_slot],
                                  ms_.kf_kp_valid[kf_slot])

    res["sub_bow_vector_ms"] = timeit(bow_only, ms)

    from orbslam2_tpu.models import keyframe_db as db_mod

    @jax.jit
    def covis_full(ms_):
        return M.covisibility(ms_).sum()

    res["sub_covisibility_KP_ms"] = timeit(covis_full, ms)

    @jax.jit
    def detect_cands(ms_, db, vec):
        return db_mod.detect_candidates(db, ms_, vec, jnp.int32(kf_slot),
                                        jnp.float32(0.01), 8)[0]

    vec = bow_only(ms)
    res["sub_detect_candidates_ms"] = timeit(detect_cands, ms, lc.db, vec)

    for k, v in res.items():
        print(f"{k:32s} {v:8.2f}")
    print(json.dumps({k: round(v, 2) for k, v in res.items()}))


if __name__ == "__main__":
    main()
