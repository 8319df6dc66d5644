"""Probe: ground-truth matching recall of the frontend + matchers.

For consecutive synthetic frames, quantify (a) detection repeatability:
how many rendered sprites get a keypoint within 1.5 px in both frames,
(b) descriptor-match recall among those, (c) stereo-depth coverage.
Separates detector losses from descriptor losses (VERDICT r2 weak #6).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from orbslam2_tpu.config import (CameraConfig, OrbConfig, STEREO,
                                     SlamConfig, CapacityConfig)
    from orbslam2_tpu.models import frame as frame_mod
    from orbslam2_tpu.ops import matching
    from orbslam2_tpu.utils import synthetic

    cfg = SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=8, max_map_points=1 << 12),
        sensor=STEREO)
    cam = cfg.camera
    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, 900, extent=(14.0, 9.0, 40.0),
                                 z_near=3.0)
    poses = synthetic.straight_trajectory(6, step=0.25)
    frontend = frame_mod.make_frontend_stereo(cfg)

    def gt_uv(Tcw):
        pc = scene.points @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        vis = (z > 0.5) & (u >= 20) & (u < cam.width - 20) & \
              (v >= 20) & (v < cam.height - 20)
        return u, v, vis, z

    fds = []
    for T in poses:
        L, R = synthetic.render_stereo(scene, cam, T, rng, noise=1.0)
        fds.append(frontend(jnp.asarray(L), jnp.asarray(R)))

    for i in (1, 2, 3):
        a, b = fds[i - 1], fds[i]
        ua, va, visa, za = gt_uv(poses[i - 1])
        ub, vb, visb, zb = gt_uv(poses[i])
        av = np.asarray(a.valid)
        bv = np.asarray(b.valid)
        xya = np.asarray(a.xy)[av]
        xyb = np.asarray(b.xy)[bv]
        lvla = np.asarray(a.level)[av]

        # assign each frame-A keypoint to the nearest sprite (within the
        # 9x9 footprint) and predict its frame-B position via the sprite's
        # ground-truth flow
        d_sp = np.hypot(xya[:, 0:1] - ua[None, visa.nonzero()[0]],
                        xya[:, 1:2] - va[None, visa.nonzero()[0]])
        sp_ids = visa.nonzero()[0][d_sp.argmin(axis=1)]
        on_sprite = d_sp.min(axis=1) < 7.0
        flow_u = ub[sp_ids] - ua[sp_ids]
        flow_v = vb[sp_ids] - va[sp_ids]
        pred = xya + np.stack([flow_u, flow_v], -1)
        sprite_vis_b = visb[sp_ids]

        # nearest frame-B keypoint to the prediction
        dmat = np.hypot(pred[:, 0:1] - xyb[None, :, 0],
                        pred[:, 1:2] - xyb[None, :, 1])
        nn = dmat.argmin(axis=1)
        nnd = dmat.min(axis=1)
        cand = on_sprite & sprite_vis_b
        rep = cand & (nnd < 1.5)
        print(f"pair {i}: kpsA={len(xya)} on_sprite={int(cand.sum())} "
              f"repeat@1.5px={int(rep.sum())} "
              f"({rep.sum() / max(cand.sum(), 1):.2f})")

        # Hamming distance of repeated pairs
        da = np.asarray(a.desc)[av]
        db = np.asarray(b.desc)[bv]
        x = np.bitwise_xor(da[rep], db[nn[rep]])
        dists = np.unpackbits(
            x.view(np.uint8), axis=1).sum(axis=1) if rep.any() else []
        if len(dists):
            dists = np.asarray(dists)
            print(f"   gt-pair Hamming: median={np.median(dists):.0f} "
                  f"p90={np.percentile(dists, 90):.0f} "
                  f"<=50: {(dists <= 50).mean():.2f} "
                  f"lvl0: {(lvla[rep] == 0).mean():.2f}")
        # descriptor matcher recall on repeated pairs
        m, d = matching.match_descriptors(
            a.desc, a.valid, b.desc, b.valid, nn_ratio=0.9,
            th=matching.TH_LOW)
        m = np.asarray(m)
        va_ids = np.flatnonzero(av)
        vb_ids = np.flatnonzero(bv)
        got = m[va_ids[rep]]
        expect = vb_ids[nn[rep]]
        print(f"   matcher recall on repeats: "
              f"{int((got == expect).sum())}/{int(rep.sum())} "
              f"wrong={int(((got >= 0) & (got != expect)).sum())}")
        has_depth = np.asarray(b.depth > 0)[bv]
        print(f"   stereo depth: {int(has_depth.sum())}/{len(has_depth)}")


if __name__ == "__main__":
    main()
