"""Probe: cumulative-prefix device time of the fused mapping program.

The composed program measures ~92 ms/kf while its stages measured solo
sum to ~36 ms — this probe rebuilds the composition stage by stage
(insert → +cullMP → +tri → +tri-insert → +fuse → +BA → +cullKF), all
compiled up front and timed INTERLEAVED in one process, so the stage
that owns the gap is pinned by back-to-back numbers on the same chip
slice.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    import jax
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.models import map_state as M
    from orbslam2_tpu.ops import triangulate as tri_mod
    from orbslam2_tpu.runtime import local_mapping, tracking as tracking_mod
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
    poses = synthetic.straight_trajectory(40, step=0.25)
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]
    eng = WindowedSlamEngine(cfg, enable_loop_closing=False, window=4)
    for i in range(40):
        eng.track_stereo(*frames[i], timestamp=0.1 * i)
    eng.flush()
    ms = eng.ms
    print(f"map: {eng.n_kfs} KFs, {eng.n_live_points} pts", flush=True)

    tfns = tracking_mod.make_tracking_fns(cfg)
    mfns = local_mapping.make_mapping_fns(cfg)
    tri_between, insert_tri = tri_mod.make_triangulation_bodies(cfg)
    TRI_NB = 10
    pay = tuple(
        jax.device_put(np.concatenate(
            [frames[36][0].astype(np.uint8).reshape(-1),
             frames[36][1].astype(np.uint8).reshape(-1)]))
        for _ in range(4))
    sT = jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
        np.float32))
    out = eng.f_track_window(ms, pay, sT, eng.last_assoc, eng.last_inlier,
                             jnp.int32(eng.ref_kf))
    jax.block_until_ready(out.summaries)

    def step_upto(stage):
        def step(m, fds, assocs, Tcws, slot, ordn):
            fd = jax.tree_util.tree_map(lambda x: x[0], fds)
            m, n = tfns.insert_keyframe_body(
                m, fd, Tcws[0], assocs[0], slot, ordn, jnp.int32(0),
                jnp.int32(99), jnp.float32(0.0))
            if stage >= 1:
                m, _ = mfns.cull_map_points_body(m, ordn)
            if stage >= 2:
                w = M.covisibility_row(m, slot)
                topw, topi = jax.lax.top_k(w, TRI_NB)
                tris = jax.vmap(lambda nb: tri_between(m, slot, nb))(topi)
                n = n + jnp.sum(tris.ok[0].astype(jnp.int32))
            if stage >= 3:
                def tri_iter(i, carry):
                    m_, n_ = carry
                    tri = jax.tree_util.tree_map(lambda x: x[i], tris)
                    free1 = m_.kf_mp[slot] < 0
                    tri = tri._replace(
                        ok=tri.ok & free1 & (topw[i] >= 15))
                    m_, n_ins = insert_tri(m_, slot, topi[i], tri, ordn)
                    return m_, n_ + n_ins
                m, n_tri = jax.lax.fori_loop(0, TRI_NB, tri_iter,
                                             (m, jnp.int32(0)))
                n = n + n_tri
            if stage >= 4:
                m, nf = mfns.fuse_into_kf_body(m, slot)
                n = n + nf
            if stage >= 5:
                m, nb = mfns.local_ba_body(m, slot)
                n = n + nb
            if stage >= 6:
                m, nk, _ = mfns.cull_keyframes_body(m, slot)
                n = n + nk
            return m, n
        return step

    names = ["P0 insert", "P1 +cullMP", "P2 +triK", "P3 +triIns",
             "P4 +fuse", "P5 +BA", "P6 +cullKF"]

    def make(stage, K):
        step = step_upto(stage)

        @jax.jit
        def run(m, fds, assocs, Tcws):
            def it(c, i):
                m_, slot, ordn = c
                m2, n = step(m_, fds, assocs, Tcws, slot, ordn)
                return (m2, slot + 1, ordn + 1), n
            _, ys = jax.lax.scan(
                it, (m, jnp.int32(100), jnp.int32(eng.kf_ordinal)),
                jnp.arange(K))
            return ys
        return run

    K = 5
    args = (ms, out.fds, out.assocs, out.Tcws)
    compiled = []
    for stage in range(7):
        f1, fk = make(stage, 1), make(stage, K)
        jax.block_until_ready(f1(*args))
        jax.block_until_ready(fk(*args))
        compiled.append((f1, fk))
        print(f"  compiled stage {stage}", flush=True)

    best = [[float("inf"), float("inf")] for _ in range(7)]
    for rnd in range(6):
        for stage, (f1, fk) in enumerate(compiled):
            t0 = time.perf_counter()
            jax.block_until_ready(f1(*args))
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(fk(*args))
            tk = time.perf_counter() - t0
            best[stage][0] = min(best[stage][0], t1)
            best[stage][1] = min(best[stage][1], tk)
    prev = 0.0
    for stage, (t1, tk) in enumerate(best):
        dev = (tk - t1) / (K - 1) * 1e3
        print(f"  {names[stage]:12s} {dev:8.2f} ms/kf  (+{dev-prev:7.2f})",
              flush=True)
        prev = dev


if __name__ == "__main__":
    main()
