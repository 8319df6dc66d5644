"""Probe: interleaved A/B of the fused mapping program's variants.

Cross-process probes disagreed by 1.7x on the same program (chip
time-sharing leaks through when the repeats land in a contended slice),
so this probe measures ALL variants in ONE process, interleaved over
several rounds, and reports the per-variant min — contention then has
to miss every round of a variant to bias its number.

Variants:
  A as-built      window_kf_step with lax.cond(do_ba)/(do_cull)
  B static-true   same bodies, BA+cull unconditional (trace-time bools)
  C tracker       the 4-frame window tracker (for the per-frame total)
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
    from orbslam2_tpu.runtime.windowed import (WindowedSlamEngine,
                                               make_window_mapping_step)

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
    zp = eng._zeros_p
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

    kf_step = make_window_mapping_step(cfg)

    def make_A(K):
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

    def step_static(m, fds, assocs, Tcws, slot, ordn):
        fd = jax.tree_util.tree_map(lambda x: x[0], fds)
        m, n_new = tfns.insert_keyframe_body(
            m, fd, Tcws[0], assocs[0], slot, ordn, jnp.int32(0),
            jnp.int32(99), jnp.float32(0.0))
        m, _ = mfns.cull_map_points_body(m, ordn)
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
        m, n_tri = jax.lax.fori_loop(0, TRI_NB, tri_iter,
                                     (m, jnp.int32(0)))
        m, _ = mfns.fuse_into_kf_body(m, slot)
        m, _ = mfns.local_ba_body(m, slot)
        m, _, _ = mfns.cull_keyframes_body(m, slot)
        return m, n_new + n_tri

    def make_B(K):
        @jax.jit
        def run(m, fds, assocs, Tcws):
            def it(c, i):
                m_, slot, ordn = c
                m2, n = step_static(m_, fds, assocs, Tcws, slot, ordn)
                return (m2, slot + 1, ordn + 1), n
            _, ys = jax.lax.scan(
                it, (m, jnp.int32(100), jnp.int32(eng.kf_ordinal)),
                jnp.arange(K))
            return ys
        return run

    def make_C(K):
        @jax.jit
        def run(m, sT_, assoc, inl):
            def it(c, i):
                sT2, a, n = c
                o = eng.f_track_window._fun(m, pay, sT2, a, n,
                                            jnp.int32(eng.ref_kf)) \
                    if hasattr(eng.f_track_window, "_fun") else \
                    eng.f_track_window(m, pay, sT2, a, n,
                                       jnp.int32(eng.ref_kf))
                return (o.state_T, o.last_assoc, o.last_inlier), \
                    o.summaries[0, 0]
            _, ys = jax.lax.scan(it, (sT_, assoc, inl), jnp.arange(K))
            return ys
        return run

    variants = {
        "A as-built(cond)": (make_A, (ms, out.fds, out.assocs, out.Tcws)),
        "B static-true   ": (make_B, (ms, out.fds, out.assocs, out.Tcws)),
        "C tracker(w=4)  ": (make_C, (ms, sT, eng.last_assoc,
                                      eng.last_inlier)),
    }

    K = 5
    compiled = {}
    for name, (mk, args) in variants.items():
        f1, fk = mk(1), mk(K)
        jax.block_until_ready(f1(*args))
        jax.block_until_ready(fk(*args))
        compiled[name] = (f1, fk, args)

    best = {name: [float("inf"), float("inf")] for name in variants}
    for rnd in range(6):
        for name, (f1, fk, args) in compiled.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f1(*args))
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(fk(*args))
            tk = time.perf_counter() - t0
            best[name][0] = min(best[name][0], t1)
            best[name][1] = min(best[name][1], tk)
    for name, (t1, tk) in best.items():
        dev = (tk - t1) / (K - 1)
        print(f"  {name}: {dev*1e3:8.2f} ms/iter  (t1 {t1*1e3:.1f}, "
              f"t{K} {tk*1e3:.1f})", flush=True)


if __name__ == "__main__":
    main()
