"""Matching + stereo + pose-optimization kernels on synthetic ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import CameraConfig, OrbConfig
from orbslam2_tpu.ops import extractor, matching, pose_opt, stereo
from orbslam2_tpu.ops.image import build_pyramid
from orbslam2_tpu.utils import camera as cam_mod
from orbslam2_tpu.utils import lie, synthetic

CAM_CFG = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                       bf=150.0, width=640, height=480)
ORB_CFG = OrbConfig(n_features=800)


def _extract(img):
    return extractor.extract(jnp.asarray(img), ORB_CFG)


def _associate(xy, valid, proj_uv, vis, tol=4.5):
    """Map each keypoint to the nearest ground-truth sprite projection."""
    out = {}
    for i in np.where(valid)[0]:
        d = np.linalg.norm(proj_uv - xy[i], axis=-1)
        d[~vis] = 1e9
        j = int(np.argmin(d))
        if d[j] <= tol:
            out[i] = j
    return out


def project_np(cfg, Tcw, pts):
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    u = cfg.fx * pc[:, 0] / np.maximum(z, 1e-9) + cfg.cx
    v = cfg.fy * pc[:, 1] / np.maximum(z, 1e-9) + cfg.cy
    return np.stack([u, v], -1), z


def test_stereo_depth_accuracy(rng):
    scene = synthetic.make_scene(rng, 500)
    Tcw = synthetic.look_ahead_pose(np.zeros(3))
    left, right = synthetic.render_stereo(scene, CAM_CFG, Tcw, rng, noise=1.0)
    fl, fr = _extract(left), _extract(right)
    pyr_l = build_pyramid(jnp.asarray(left), ORB_CFG.n_levels, ORB_CFG.scale_factor)
    pyr_r = build_pyramid(jnp.asarray(right), ORB_CFG.n_levels, ORB_CFG.scale_factor)
    sm = stereo.match_stereo(fl, fr, pyr_l, pyr_r, CAM_CFG.bf, CAM_CFG.fx,
                             ORB_CFG.scale_factor)
    depth = np.asarray(sm.depth)
    matched = depth > 0
    assert matched.sum() > 150, matched.sum()

    uv, z = project_np(CAM_CFG, Tcw, scene.points)
    assoc = _associate(np.asarray(fl.xy), np.asarray(fl.valid), uv, z > 0)
    errs = []
    for i, j in assoc.items():
        if matched[i]:
            # disparity error in px — the honest metric for the matcher
            errs.append(abs(CAM_CFG.bf / depth[i] - CAM_CFG.bf / z[j]))
    errs = np.asarray(errs)
    assert len(errs) > 80, len(errs)
    # sub-third-of-a-pixel median disparity error, few gross outliers
    assert np.median(errs) < 0.35, np.median(errs)
    assert np.mean(errs < 1.5) > 0.85, np.mean(errs < 1.5)


def test_match_descriptors_two_views(rng):
    scene = synthetic.make_scene(rng, 500)
    T1 = synthetic.look_ahead_pose(np.zeros(3))
    T2 = synthetic.look_ahead_pose(np.array([0.3, 0.05, 0.4]))
    im1 = synthetic.render(scene, CAM_CFG, T1, rng, 1.0)
    im2 = synthetic.render(scene, CAM_CFG, T2, rng, 1.0)
    f1, f2 = _extract(im1), _extract(im2)
    m, dist = matching.match_descriptors(
        f1.desc, f1.valid, f2.desc, f2.valid, nn_ratio=0.9, th=matching.TH_LOW,
        angle_a=f1.angle, angle_b=f2.angle)
    m = np.asarray(m)
    ok = m >= 0
    assert ok.sum() > 120, ok.sum()

    uv1, z1 = project_np(CAM_CFG, T1, scene.points)
    uv2, z2 = project_np(CAM_CFG, T2, scene.points)
    a1 = _associate(np.asarray(f1.xy), np.asarray(f1.valid), uv1, z1 > 0)
    a2 = _associate(np.asarray(f2.xy), np.asarray(f2.valid), uv2, z2 > 0)
    good = bad = 0
    for i in np.where(ok)[0]:
        j = m[i]
        if i in a1 and j in a2:
            if a1[i] == a2[j]:
                good += 1
            else:
                bad += 1
    assert good > 100, (good, bad)
    assert bad / max(good + bad, 1) < 0.12, (good, bad)  # assoc-oracle noise included


def test_search_by_projection_tracks_points(rng):
    scene = synthetic.make_scene(rng, 500)
    T1 = synthetic.look_ahead_pose(np.zeros(3))
    T2 = synthetic.look_ahead_pose(np.array([0.2, 0.0, 0.3]))
    im1 = synthetic.render(scene, CAM_CFG, T1, rng, 1.0)
    im2 = synthetic.render(scene, CAM_CFG, T2, rng, 1.0)
    f1, f2 = _extract(im1), _extract(im2)
    cam = cam_mod.Camera.from_config(CAM_CFG)

    # build "map points" from frame-1 keypoints using ground-truth depth
    uv1, z1 = project_np(CAM_CFG, T1, scene.points)
    a1 = _associate(np.asarray(f1.xy), np.asarray(f1.valid), uv1, z1 > 0)
    kp_ids = np.asarray(sorted(a1.keys()))
    pt_ids = np.asarray([a1[i] for i in kp_ids])
    n = f1.n
    pos = np.zeros((n, 3), np.float32)
    pos[kp_ids] = scene.points[pt_ids]
    valid = np.zeros(n, bool)
    valid[kp_ids] = True
    # mean viewing direction: camera-1 center → point (MapPoint convention)
    C1 = -T1[:3, :3].T @ T1[:3, 3]
    nrm = pos - C1[None]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    dist1 = np.linalg.norm(pos - C1[None], axis=-1)
    # scale-invariance band as MapPoint::UpdateNormalAndDepth builds it:
    # maxDist = dist·scale^level, minDist = maxDist/scale^(nLevels−1),
    # with the 0.8/1.2 frustum slack of Get{Min,Max}DistanceInvariance
    lvl = np.asarray(f1.level)
    maxd = dist1 * ORB_CFG.scale_factor ** lvl
    mind = maxd / ORB_CFG.scale_factor ** (ORB_CFG.n_levels - 1)
    query = matching.ProjectionQuery(
        pos_w=jnp.asarray(pos), normal=jnp.asarray(nrm, jnp.float32),
        min_dist=jnp.asarray(0.8 * mind, jnp.float32),
        max_dist=jnp.asarray(1.2 * maxd, jnp.float32),
        desc=f1.desc, valid=jnp.asarray(valid))

    match, dists, uv = matching.search_by_projection(
        cam, jnp.asarray(T2, jnp.float32), query,
        f2.xy, f2.level, f2.desc, f2.valid,
        jnp.full((n,), -1.0), ORB_CFG.scale_factor, ORB_CFG.n_levels,
        radius=4.0, nn_ratio=0.9)
    match = np.asarray(matching.resolve_duplicates(
        match, dists.astype(jnp.int32), n))

    uv2, z2 = project_np(CAM_CFG, T2, scene.points)
    a2 = _associate(np.asarray(f2.xy), np.asarray(f2.valid), uv2, z2 > 0)
    good = bad = 0
    for i in np.where(match >= 0)[0]:
        j = match[i]
        if i in a1 and j in a2:
            if a1[i] == a2[j]:
                good += 1
            else:
                bad += 1
    assert good > 80, (good, bad)
    assert bad / max(good + bad, 1) < 0.12, (good, bad)  # assoc-oracle noise included


def _make_pose_obs(rng, n=200, outlier_frac=0.2, noise_px=0.5):
    cam = cam_mod.Camera.from_config(CAM_CFG)
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 20, n)], -1)
    xi_true = np.array([0.03, -0.05, 0.02, 0.2, -0.1, 0.15], np.float32)
    T_true = np.asarray(lie.se3_exp(jnp.asarray(xi_true)))
    uv, z = project_np(CAM_CFG, T_true, pts)
    uv = uv + rng.normal(0, noise_px, uv.shape)
    ur = uv[:, 0] - CAM_CFG.bf / z
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(15, 60, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    obs = pose_opt.PoseObs(
        pts_w=jnp.asarray(pts, jnp.float32),
        uv=jnp.asarray(uv, jnp.float32),
        ur=jnp.asarray(ur, jnp.float32),
        inv_sigma2=jnp.ones(n, jnp.float32),
        valid=jnp.ones(n, bool))
    return cam, T_true, obs, out_idx


def test_pose_optimization_converges(rng):
    cam, T_true, obs, out_idx = _make_pose_obs(rng)
    xi0 = np.array([0.01, -0.03, 0.01, 0.1, 0.0, 0.05], np.float32)
    T0 = jnp.asarray(lie.se3_exp(jnp.asarray(xi0)) @ jnp.asarray(T_true, jnp.float32))
    T_est, inliers, n_in = pose_opt.pose_optimization(cam, T0, obs)
    T_est = np.asarray(T_est)
    # pose error
    dT = T_est @ np.linalg.inv(T_true)
    rot_err = np.degrees(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1)))
    trans_err = np.linalg.norm(dT[:3, 3])
    assert rot_err < 0.1, rot_err
    assert trans_err < 0.02, trans_err
    # outliers flagged
    inliers = np.asarray(inliers)
    assert inliers[out_idx].mean() < 0.1
    assert inliers.mean() > 0.7


def test_pose_optimization_mono_obs(rng):
    cam, T_true, obs, out_idx = _make_pose_obs(rng, outlier_frac=0.1)
    obs = obs._replace(ur=jnp.full_like(obs.ur, -1.0))  # all mono
    T0 = jnp.asarray(T_true, jnp.float32)
    T_est, inliers, n_in = pose_opt.pose_optimization(cam, T0, obs)
    dT = np.asarray(T_est) @ np.linalg.inv(T_true)
    assert np.linalg.norm(dT[:3, 3]) < 0.02


def test_rotation_consistency(rng):
    n = 200
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang_b = ang_a - 0.3  # consistent global rotation
    bad = rng.choice(n, 30, replace=False)
    ang_b[bad] = rng.uniform(0, 2 * np.pi, 30)
    ok = matching.rotation_consistency_mask(
        jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.ones(n, bool))
    ok = np.asarray(ok)
    good_mask = np.ones(n, bool)
    good_mask[bad] = False
    assert ok[good_mask].mean() > 0.95
    assert ok[bad].mean() < 0.35


def test_hamming_mxu_form_bit_identical(rng):
    """The bf16 matmul Hamming form used for large N*M must be
    bit-identical to the popcount reference at and around the routing
    threshold (ops/hamming.py)."""
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.ops import hamming

    for (n, m) in [(64, 64), (1024, 1024), (4096, 1024)]:
        a = jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32))
        ref = jnp.sum(jax.lax.population_count(
            a[:, None, :] ^ b[None, :, :]), -1).astype(jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(hamming.hamming_matrix(a, b)), np.asarray(ref))


def _np_match_descriptors(a, av, b, bv, nn_ratio, th):
    """NumPy reference of match_descriptors without the rotation check:
    dense Hamming, first-index argmin, ratio test, one source per target
    (lowest distance, then lowest source index)."""
    x = a.view(np.uint8)[:, None, :] ^ b.view(np.uint8)[None, :, :]
    d = np.unpackbits(x, axis=-1).sum(-1).astype(np.int32)
    d[~(av[:, None] & bv[None, :])] = 256
    idx = d.argmin(1)
    rows = np.arange(len(a))
    best = d[rows, idx]
    d2 = d.copy()
    d2[rows, idx] = 256
    second = d2.min(1)
    ok = (best <= th) & (best < nn_ratio * second) & av
    match = np.where(ok, idx, -1)
    for t in np.unique(match[match >= 0]):
        srcs = np.flatnonzero(match == t)
        keep = srcs[np.argmin(best[srcs])]       # first of the minima
        match[srcs[srcs != keep]] = -1
    return match, best, idx, second


@pytest.mark.parametrize("A,B", [(1024, 1024), (600, 4608)])
def test_match_descriptors_equals_dense_reference(rng, A, B):
    """match_descriptors is masked_hamming_matrix + best_and_second + the
    ratio test + duplicate resolution, with invalid rows and ties."""
    from orbslam2_tpu.ops import hamming

    b = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
    b[1::50] = b[0::50][:len(b[1::50])]          # tied targets
    a = rng.integers(0, 2 ** 32, (A, 8), dtype=np.uint32)
    src = rng.choice(B, A // 2)
    src[:40] = src[40:80]                        # two sources per target
    bits = np.unpackbits(b[src].view(np.uint8), axis=1)
    flips = rng.random(bits.shape) < rng.uniform(0, 0.25, (A // 2, 1))
    a[:A // 2] = np.packbits(bits ^ flips, axis=1).view(np.uint32)
    av = rng.random(A) < 0.9
    bv = rng.random(B) < 0.9

    m, d = matching.match_descriptors(
        jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv),
        nn_ratio=0.7, th=matching.TH_LOW, check_rotation=False)
    rm, rbest, ridx, rsec = _np_match_descriptors(a, av, b, bv, 0.7,
                                                  matching.TH_LOW)
    assert (rm >= 0).sum() > A // 10                 # the case is not empty
    np.testing.assert_array_equal(np.asarray(m), rm)
    np.testing.assert_array_equal(np.asarray(d), rbest)

    best, idx, sec = matching.best_and_second(hamming.masked_hamming_matrix(
        jnp.asarray(a), jnp.asarray(av), jnp.asarray(b), jnp.asarray(bv)))
    np.testing.assert_array_equal(np.asarray(best), rbest)
    np.testing.assert_array_equal(np.asarray(idx), ridx)
    np.testing.assert_array_equal(np.asarray(sec), rsec)
