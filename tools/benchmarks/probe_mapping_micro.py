"""Micro-probe: device time of each body inside the mapping step.

Times insert_keyframe / tri_between / the insert_tri fori loop / fuse /
local BA (at several iteration counts) / kf-cull independently via
K-chained scans, so optimization effort lands on the right body.
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
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.runtime import local_mapping
    from orbslam2_tpu.ops import triangulate as tri_mod
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
    kf = jnp.int32(eng.ref_kf)
    print(f"map: {eng.n_kfs} KFs, {eng.n_live_points} pts", flush=True)

    mfns = local_mapping.make_mapping_fns(cfg)
    tri_between, insert_tri = tri_mod.make_triangulation_bodies(cfg)
    TRI_NB = 10

    def chain_ms_body(body):
        """body: (ms, kf) -> (ms, aux).  Chain K times feeding ms back."""
        def make(K):
            @jax.jit
            def run(ms_, kf_):
                def it(m, _):
                    m2, aux = body(m, kf_)
                    return m2, jnp.asarray(aux).reshape(-1)[0]
                m2, ys = jax.lax.scan(it, ms_, None, length=K)
                return ys
            return run
        return make

    def report(name, make, args, k=5):
        dev, oh = measure_chained(make, args, k=k)
        print(f"  {name:22s} {dev*1e3:8.2f} ms (overhead {oh*1e3:.1f})",
              flush=True)
        return dev

    report("local_ba(5+10)", chain_ms_body(mfns.local_ba_body), (ms, kf))

    # BA iteration scaling: rebuild with altered iters via bundle directly
    from orbslam2_tpu.ops import bundle  # noqa
    import orbslam2_tpu.runtime.local_mapping as lm

    import dataclasses
    cfg_1 = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer,
        additional_iterations_no_outliers=1, additional_iterations=0))
    mfns_1 = local_mapping.make_mapping_fns(cfg_1)
    report("local_ba(1+0)", chain_ms_body(mfns_1.local_ba_body), (ms, kf))
    cfg_5 = cfg.replace(optimizer=dataclasses.replace(
        cfg.optimizer,
        additional_iterations_no_outliers=5, additional_iterations=0))
    mfns_5 = local_mapping.make_mapping_fns(cfg_5)
    report("local_ba(5+0)", chain_ms_body(mfns_5.local_ba_body), (ms, kf))

    report("cull_map_points", chain_ms_body(
        lambda m, k_: mfns.cull_map_points_body(m, jnp.int32(20))),
        (ms, kf))
    report("cull_keyframes",
           chain_ms_body(lambda m, k_: mfns.cull_keyframes_body(m, k_)[:2]),
           (ms, kf))
    report("fuse_into_kf", chain_ms_body(mfns.fuse_into_kf_body), (ms, kf))

    # triangulation: vmapped tri_between over TRI_NB neighbours
    from orbslam2_tpu.models import map_state as M

    def tri_vmap_body(m, k_):
        w = M.covisibility_row(m, k_)
        topw, topi = jax.lax.top_k(w, TRI_NB)
        tris = jax.vmap(lambda nb: tri_between(m, k_, nb))(topi)
        return m, tris.ok.sum()

    def make_tri(K):
        @jax.jit
        def run(ms_, kf_):
            def it(c, _):
                # anti-CSE: kf depends on the loop carry so XLA cannot
                # hoist the body out of the scan
                kf_i = jnp.where(c >= 0, kf_, 0)
                m, aux = tri_vmap_body(ms_, kf_i)
                return c + aux, aux
            c, ys = jax.lax.scan(it, jnp.int32(0), None, length=K)
            return ys
        return run
    report("tri_between x10 (vmap)", make_tri, (ms, kf))

    # insert_tri fori loop
    w = M.covisibility_row(ms, kf)
    topw, topi = jax.lax.top_k(w, TRI_NB)
    tris = jax.jit(jax.vmap(lambda nb: tri_between(ms, kf, nb)))(topi)

    def make_ins(K):
        @jax.jit
        def run(ms_, kf_, tris_, topi_, topw_):
            def it(m, _):
                def tri_iter(i, carry):
                    m2, n_ = carry
                    tri = jax.tree_util.tree_map(lambda x: x[i], tris_)
                    free1 = m2.kf_mp[kf_] < 0
                    tri = tri._replace(ok=tri.ok & free1 & (topw_[i] >= 15))
                    m2, n_ins = insert_tri(m2, kf_, topi_[i], tri,
                                           jnp.int32(12))
                    return m2, n_ + n_ins
                m3, n = jax.lax.fori_loop(0, TRI_NB, tri_iter,
                                          (m, jnp.int32(0)))
                return m3, n
            m2, ys = jax.lax.scan(it, ms_, None, length=K)
            return ys
        return run
    report("insert_tri x10 (fori)", make_ins, (ms, kf, tris, topi, topw))

    def make_ins1(K):
        @jax.jit
        def run(ms_, kf_, tris_, topi_, topw_):
            def it(m, _):
                tri = jax.tree_util.tree_map(lambda x: x[0], tris_)
                free1 = m.kf_mp[kf_] < 0
                tri = tri._replace(ok=tri.ok & free1 & (topw_[0] >= 15))
                m2, n_ins = insert_tri(m, kf_, topi_[0], tri, jnp.int32(12))
                return m2, n_ins
            m2, ys = jax.lax.scan(it, ms_, None, length=K)
            return ys
        return run
    report("insert_tri x1", make_ins1, (ms, kf, tris, topi, topw))

    # insert_keyframe_body
    from orbslam2_tpu.runtime import tracking as tracking_mod
    tfns = tracking_mod.make_tracking_fns(cfg)
    fd = eng.last_fd
    if fd is not None:
        def make_ik(K):
            @jax.jit
            def run(ms_, fd_, Tcw, assoc):
                def it(m, i):
                    m2, n = tfns.insert_keyframe_body(
                        m, fd_, Tcw, assoc, jnp.int32(100), jnp.int32(20),
                        jnp.int32(0), jnp.int32(99), jnp.float32(0.0))
                    return m2, n
                m2, ys = jax.lax.scan(it, ms_, jnp.arange(K))
                return ys
            return run
        report("insert_keyframe", make_ik,
               (ms, fd, jnp.asarray(eng.last_Tcw), eng.last_assoc))
    else:
        print("  (no last_fd cached; skipping insert_keyframe)")


if __name__ == "__main__":
    main()
