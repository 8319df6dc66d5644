"""Probe: is the fused mapping step slower than the sum of its bodies?

Micro timings sum to ~42 ms but the fused step measures ~81-89 ms.
Suspects: the lax.cond wrappers around BA/cull (whole-MapState operands)
and scheduling across the fused program.  Measures: (a) the step as
built, (b) a no-cond variant running BA+cull unconditionally, (c) the
bodies inlined sequentially without the window-row gather.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    import jax
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                     STEREO, SlamConfig)
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.runtime import local_mapping, tracking as tracking_mod
    from orbslam2_tpu.ops import triangulate as tri_mod
    from orbslam2_tpu.models import map_state as M
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
    fd = eng.last_fd
    Tcw = jnp.asarray(eng.last_Tcw, jnp.float32)
    assoc = eng.last_assoc
    zp = eng._zeros_p

    def step_nocond(m, fd_, Tcw_, assoc_, slot, ordn):
        m, n_new = tfns.insert_keyframe_body(
            m, fd_, Tcw_, assoc_, slot, ordn, jnp.int32(0), jnp.int32(99),
            jnp.float32(0.0))
        m, n_culled = mfns.cull_map_points_body(m, ordn)
        w = M.covisibility_row(m, slot)
        topw, topi = jax.lax.top_k(w, TRI_NB)
        tris = jax.vmap(lambda nb: tri_between(m, slot, nb))(topi)

        def tri_iter(i, carry):
            m_, n_ = carry
            tri = jax.tree_util.tree_map(lambda x: x[i], tris)
            free1 = m_.kf_mp[slot] < 0
            tri = tri._replace(ok=tri.ok & free1 & (topw[i] >= 15))
            m_, n_ins = insert_tri(m_, slot, topi[i], tri, ordn)
            return m_, n_ + n_ins
        m, n_tri = jax.lax.fori_loop(0, TRI_NB, tri_iter, (m, jnp.int32(0)))
        m, n_fused = mfns.fuse_into_kf_body(m, slot)
        m, n_out = mfns.local_ba_body(m, slot)
        m, n_kc, victims = mfns.cull_keyframes_body(m, slot)
        return m, n_new + n_tri + n_fused + n_out + n_kc

    def make_nocond(K):
        @jax.jit
        def run(m, fd_, Tcw_, assoc_):
            def it(c, i):
                m_, slot, ordn = c
                m2, n = step_nocond(m_, fd_, Tcw_, assoc_, slot, ordn)
                return (m2, slot + 1, ordn + 1), n
            _, ys = jax.lax.scan(
                it, (m, jnp.int32(100), jnp.int32(eng.kf_ordinal)),
                jnp.arange(K))
            return ys
        return run

    dev, oh = measure_chained(make_nocond, (ms, fd, Tcw, assoc), k=5)
    print(f"  mapping no-cond inline: {dev*1e3:8.2f} ms/kf "
          f"(overhead {oh*1e3:.1f})", flush=True)

    # as-built step (conds, window-row gather) at same call shape
    from orbslam2_tpu.runtime.windowed import make_window_mapping_step
    kf_step = make_window_mapping_step(cfg)
    out = eng.f_track_window(
        ms, eng.prewarm_payload() if hasattr(eng, "prewarm_payload") else
        tuple(np.zeros(2 * 480 * 640, np.uint8) for _ in range(4)),
        jnp.asarray(np.stack([eng.last_Tcw, eng.last_Tcw]).astype(
            np.float32)), assoc, eng.last_inlier, jnp.int32(eng.ref_kf))
    jax.block_until_ready(out.summaries)

    def make_ascur(K):
        @jax.jit
        def run(m, fds, assocs, Tcws):
            def it(c, i):
                m_, slot, ordn = c
                m2, stats = kf_step(m_, fds, assocs, Tcws, jnp.int32(0),
                                    slot, ordn, jnp.int32(0), jnp.int32(99),
                                    jnp.float32(0.0), jnp.bool_(True),
                                    jnp.bool_(True), zp, zp)
                return (m2, slot + 1, ordn + 1), stats[0]
            _, ys = jax.lax.scan(
                it, (m, jnp.int32(100), jnp.int32(eng.kf_ordinal)),
                jnp.arange(K))
            return ys
        return run

    dev2, oh2 = measure_chained(
        make_ascur, (ms, out.fds, out.assocs, out.Tcws), k=5)
    print(f"  mapping as-built:       {dev2*1e3:8.2f} ms/kf "
          f"(overhead {oh2*1e3:.1f})", flush=True)


if __name__ == "__main__":
    main()
