"""Proof that the SLAM main path runs on the GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases (one line each, with compile seconds, run seconds and result):

* identity  — JAX devices, ``nvidia-smi`` name and power limit, the
  matmul precision, and whether the C++ runtime core (``make -C csrc``)
  loaded;
* stereo System — ``System.track_stereo`` over 76 frames of the
  ``bench.py`` corridor (640×480, 1000 ORB features, 128 keyframes,
  16384 map points, loop closing on), judged by ATE against ground truth;
* stereo windowed — the same frames through ``WindowedSlamEngine``
  (what ``bench.py`` times), then four LOC windows on its map;
* mono / RGB-D System — H/F initialization, EPnP and the RGB-D frontend;
* loop closure — a 144-frame outward orbit through the windowed engine;
* parity — the brute-force matcher and the stereo frontend against the
  same programs on the host CPU, in this process.

Exits non-zero, before compiling anything, when JAX finds no GPU.  The last
line of a passing run is the JSON object ``{"ok": true, "device": ...}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FRAMES = 76              # stereo frames through System and the windowed engine
LOC_WINDOW = 4           # frames per LOC-mode program
LOC_WINDOWS = 4
ATE_LIMIT_M = 0.10       # the cv2 proxy reaches 0.1127 m on these frames
TRACKED_MIN = 0.95
KF_MIN = 5
MIN_INLIERS = 30         # Tracking.cc:1004 — fewer map inliers is LOST
# Frontend parity, GPU vs CPU: the pixel-domain einsums run as TF32 on
# the GPU and as f32 on the CPU (PERF.md, "Frontend parity").
KP_OVERLAP_MIN = 0.90
KP_OVERLAP_L0_MIN = 0.99
DESC_HAMMING_MAX = 8.0
BA_POSE_ATOL = 1e-3      # 4-card vs 1-card BA: CG sums in another order


def require_gpus(n_cards):
    """Exit non-zero unless JAX sees ``n_cards`` GPUs; compiles nothing."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPU(s); JAX found "
                 f"{len(devs)} {devs[0].platform} device(s)")


def _line(phase, compile_s, run_s, result, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    print(f"phase {phase}: compile_s={compile_s:.1f} run_s={run_s:.1f} "
          f"result={result} {fields}".rstrip(), flush=True)


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _build_native():
    """Build the C++ runtime core; the Python fallback covers a failure."""
    r = subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "csrc")],
                       capture_output=True, text=True, timeout=300)
    return r.returncode == 0, (r.stderr or r.stdout).strip()[-300:]


def _cfg(sensor):
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     OrbConfig, SlamConfig)
    return SlamConfig(
        camera=CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            bf=150.0, width=640, height=480, fps=10.0,
                            th_depth=60.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=1 << 14,
                                local_ba_keyframes=8, local_ba_points=2048),
        sensor=sensor)


def _centers(poses):
    return [None if T is None else -T[:3, :3].T @ T[:3, 3] for T in poses]


def _ate(est, gt, T0=None):
    """RMSE of camera centers.  The engine's world frame is its first
    camera ``T0`` (default ``gt[0]``); estimates are rebased into the
    ground-truth world."""
    T0 = gt[0] if T0 is None else T0
    errs = [np.sum((ce - cg) ** 2) for ce, cg in
            zip(_centers([None if T is None else T @ T0 for T in est]),
                _centers(gt)) if ce is not None]
    return float(np.sqrt(np.mean(errs))) if errs else float("inf"), len(errs)


def _timed(fn, reps=20):
    """Median wall seconds of ``fn`` after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ------------------------------------------------------------------ phases

def print_identity():
    """Print the device identity line and the card's power limit."""
    import jax
    native_built, native_log = _build_native()
    from orbslam2_tpu.runtime import native
    d = jax.devices()[0]
    print(f"identity: platform={d.platform} kind={d.device_kind!r} "
          f"count={len(jax.devices())} "
          f"matmul_precision={jax.config.jax_default_matmul_precision} "
          f"native_core={'loaded' if native.have_native() else 'python'} "
          f"make_ok={native_built}", flush=True)
    if not native_built:
        print(f"identity: make -C csrc failed: {native_log}", flush=True)
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    return d


def stereo_sequence(n):
    """The first ``n`` frames ``bench.py`` renders, and their poses."""
    from orbslam2_tpu.utils import synthetic
    cam = _cfg(None).camera
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    poses = synthetic.straight_trajectory(n, step=0.25)
    frames = [synthetic.render_world_stereo(world, cam, T, rng, noise=1.0)
              for T in poses]
    return world, poses, frames


def _judge_stereo(name, eng, poses, compile_s, run_s, **extra):
    est = eng.frame_poses()
    ate, n_tracked = _ate(est, poses)
    frac = n_tracked / len(poses)
    kfs = eng.stats["kf_inserted"]
    ok = ate <= ATE_LIMIT_M and frac >= TRACKED_MIN and kfs >= KF_MIN
    _line(name, compile_s, run_s, "pass" if ok else "FAIL",
          ate_m=f"{ate:.4f}", tracked=f"{n_tracked}/{len(poses)}",
          keyframes=kfs, loops=eng.stats.get("loops_closed", 0), **extra)
    assert ok, f"{name}: ate={ate} tracked={frac} kfs={kfs}"


def phase_stereo_system(poses, frames):
    import jax
    import jax.numpy as jnp
    from orbslam2_tpu.config import STEREO
    from orbslam2_tpu.runtime.system import System

    system = System(None, None, sensor=STEREO, config=_cfg(STEREO))
    eng = system.engine
    t0 = time.perf_counter()
    eng.prewarm()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (l, r) in enumerate(frames):
        system.track_stereo(l, r, 0.1 * i)
    system.shutdown()
    run_s = time.perf_counter() - t0

    # the reference-keyframe fallback program, whole, on the live map
    l, r = frames[-1]
    fd = jax.jit(eng.frontend)(jnp.asarray(l, jnp.float32),
                               jnp.asarray(r, jnp.float32))
    T = jnp.asarray(eng.last_Tcw, jnp.float32)
    k = jnp.int32(eng.ref_kf)
    t_ref = _timed(lambda: eng.f_track_ref(eng.ms, fd, k, T).summary)
    _judge_stereo("stereo_system", eng, poses, compile_s, run_s,
                  track_ref_kf_ms=f"{t_ref * 1e3:.3f}")


def phase_stereo_windowed(world, poses, frames):
    from orbslam2_tpu.config import STEREO
    from orbslam2_tpu.runtime import streaming, tracking
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.utils import synthetic
    import jax
    import jax.numpy as jnp

    cfg = _cfg(STEREO)
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    t0 = time.perf_counter()
    eng.prewarm()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (l, r) in enumerate(frames):
        eng.track_stereo(l, r, timestamp=0.1 * i)
    eng.flush()
    eng.finish_gba()
    run_s = time.perf_counter() - t0
    _judge_stereo("stereo_windowed", eng, poses, compile_s, run_s)

    # LOC mode on that map: the frames that follow along the corridor
    n = len(frames) + LOC_WINDOW * LOC_WINDOWS
    loc_poses = synthetic.straight_trajectory(n, step=0.25)[len(frames):]
    rng = np.random.default_rng(1)
    loc_frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                                noise=1.0)
                  for T in loc_poses]
    track_window = streaming.make_window_tracker(cfg, LOC_WINDOW)
    vel_inv = (np.linalg.inv(eng.velocity) if eng.velocity is not None
               else np.eye(4))
    state_T = jnp.asarray(np.stack([eng.last_Tcw,
                                    vel_inv @ eng.last_Tcw]).astype(
                                        np.float32))
    assoc, ref_kf = eng.last_assoc, jnp.int32(eng.ref_kf)
    summaries, loc_compile, t0 = [], None, time.perf_counter()
    for w in range(LOC_WINDOWS):
        win = loc_frames[w * LOC_WINDOW:(w + 1) * LOC_WINDOW]
        flat = jax.device_put(streaming.pack_window_uint8(
            [(l.astype(np.uint8), r.astype(np.uint8)) for l, r in win]))
        res = track_window(eng.ms, flat, state_T, assoc, ref_kf)
        summaries.append(np.asarray(res.summaries))
        if loc_compile is None:
            loc_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
        state_T, assoc = res.state_T, res.assoc
    loc_run = time.perf_counter() - t0
    est = [tracking.Summary(v) for s in summaries for v in s]
    finite = all(np.all(np.isfinite(s.Tcw)) for s in est)
    tracked = sum(s.n_inliers_map >= MIN_INLIERS for s in est)
    ate, _ = _ate([s.Tcw for s in est], loc_poses, T0=poses[0])
    ok = finite and tracked == len(est)
    _line("loc_windows", loc_compile, loc_run, "pass" if ok else "FAIL",
          frames=len(est), tracked=tracked, finite=finite,
          ate_m=f"{ate:.4f}")
    assert ok, f"loc: finite={finite} tracked={tracked}/{len(est)}"


def _judge_init(name, outs, compile_s, run_s):
    first = next((i for i, T in enumerate(outs) if T is not None), None)
    after = outs[first:] if first is not None else []
    tracked = sum(T is not None for T in after)
    ok = first is not None and tracked >= 0.8 * len(after)
    _line(name, compile_s, run_s, "pass" if ok else "FAIL",
          initialized_at=first, tracked_after_init=f"{tracked}/{len(after)}")
    assert ok, f"{name}: init={first} tracked={tracked}/{len(after)}"


def phase_mono_system(world, n=48):
    from orbslam2_tpu.config import MONOCULAR
    from orbslam2_tpu.runtime.system import System
    from orbslam2_tpu.utils import synthetic

    cfg = _cfg(MONOCULAR)
    rng = np.random.default_rng(2)
    # sideways-dominant motion: the H/F bootstrap needs parallax
    poses = [synthetic.look_ahead_pose(np.array([0.18 * i, 0.0, 0.04 * i]))
             for i in range(n)]
    frames = [synthetic.render_world(world, cfg.camera, T, rng, noise=1.0)
              for T in poses]
    system = System(None, None, sensor=MONOCULAR, config=cfg)
    t0 = time.perf_counter()
    system.engine.prewarm()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [system.track_monocular(f, 0.1 * i) for i, f in enumerate(frames)]
    system.shutdown()
    _judge_init("mono_system", outs, compile_s, time.perf_counter() - t0)


def phase_rgbd_system(world, n=48):
    from orbslam2_tpu.config import RGBD
    from orbslam2_tpu.runtime.system import System
    from orbslam2_tpu.utils import synthetic

    cfg = _cfg(RGBD)
    rng = np.random.default_rng(3)
    poses = synthetic.straight_trajectory(n, step=0.12)
    frames = [synthetic.render_world(world, cfg.camera, T, rng, noise=1.0,
                                     with_depth=True) for T in poses]
    system = System(None, None, sensor=RGBD, config=cfg)
    t0 = time.perf_counter()
    system.engine.prewarm()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [system.track_rgbd(g, d, i / 30.0)
            for i, (g, d) in enumerate(frames)]
    system.shutdown()
    _judge_init("rgbd_system", outs, compile_s, time.perf_counter() - t0)


def phase_loop_closure(n=144):
    from orbslam2_tpu.config import STEREO
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.utils import synthetic

    cfg = _cfg(STEREO)
    rng = np.random.default_rng(0)
    scene = synthetic.orbit_scene(rng)
    # 1.25 turns: the consistency check needs several keyframes after
    # the first revisit (LoopClosing.cc:188-248).  3.1°/frame: at twice
    # that the windowed engine, tracking up to a window against a stale
    # map, loses the camera where the per-frame engine does not.
    poses = synthetic.outward_orbit(n, radius=4.0, z_center=10.0,
                                    turns=1.25)
    frames = [synthetic.render_stereo(scene, cfg.camera, T, rng, 1.0)
              for T in poses]
    eng = WindowedSlamEngine(cfg, enable_loop_closing=True, window=4)
    t0 = time.perf_counter()
    eng.prewarm()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (l, r) in enumerate(frames):
        eng.track_stereo(l, r, timestamp=0.1 * i)
    eng.finish_gba()
    run_s = time.perf_counter() - t0
    ate, n_tracked = _ate(eng.frame_poses(), poses)
    loops = eng.stats.get("loops_closed", 0)
    ok = loops >= 1
    _line("loop_closure", compile_s, run_s, "pass" if ok else "FAIL",
          loops=loops, tracked=f"{n_tracked}/{n}", ate_m=f"{ate:.4f}",
          gba=eng.loop_closer.gba.stats)
    assert ok, f"loop closure: {eng.stats}"


def _descriptors(rng, n, valid_frac=0.9):
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    # exact duplicates make ties in the argmin and the ratio test
    desc[1::97] = desc[0::97][:len(desc[1::97])]
    return desc, rng.random(n) < valid_frac


def phase_parity(frames):
    import jax
    from orbslam2_tpu.config import STEREO
    from orbslam2_tpu.models import frame as frame_mod
    from orbslam2_tpu.ops import hamming, matching

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    rng = np.random.default_rng(4)

    # ---- brute-force matcher: integer ops and {0,1} bf16 products summed
    # in f32 are exact, so the card must agree bit for bit
    @jax.jit
    def match(a, av, b, bv):
        return matching.match_descriptors(a, av, b, bv, check_rotation=False)

    @jax.jit
    def top2(a, av, b, bv):
        return matching.best_and_second(
            hamming.masked_hamming_matrix(a, av, b, bv))

    t0 = time.perf_counter()
    times, same = {}, True
    for A, B in ((1024, 1024), (1024, 4608)):
        a, av = _descriptors(rng, A)
        b, bv = _descriptors(rng, B)
        args = (a, av, b, bv)
        on_gpu = jax.device_put(args, gpu)
        on_cpu = jax.device_put(args, cpu)
        for fn in (match, top2):
            g = jax.tree.map(np.asarray, fn(*on_gpu))
            c = jax.tree.map(np.asarray, fn(*on_cpu))
            same &= all(np.array_equal(x, y) for x, y in zip(g, c))
        times[f"{A}x{B}"] = _timed(lambda: top2(*on_gpu))
    run_s = time.perf_counter() - t0
    _line("parity_matcher", 0.0, run_s, "pass" if same else "FAIL",
          bit_identical=same,
          **{f"hamming_top2_{k}_ms": f"{v * 1e3:.4f}"
             for k, v in times.items()})
    assert same, "matcher differs between GPU and CPU"

    # ---- stereo frontend on one 640×480 pair
    frontend = jax.jit(frame_mod.make_frontend_stereo(_cfg(STEREO)))
    l, r = (np.asarray(x, np.float32) for x in frames[20])
    t0 = time.perf_counter()
    g = jax.tree.map(np.asarray, frontend(*jax.device_put((l, r), gpu)))
    c = jax.tree.map(np.asarray, frontend(*jax.device_put((l, r), cpu)))
    run_s = time.perf_counter() - t0

    def keyed(fd):
        """(x, y in 1/100 px, level) → row, for the valid keypoints."""
        xy = np.rint(fd.xy * 100).astype(np.int64)
        return {(int(xy[i, 0]), int(xy[i, 1]), int(fd.level[i])): i
                for i in np.flatnonzero(fd.valid)}

    kg, kc = keyed(g), keyed(c)
    common = kg.keys() & kc.keys()
    overlap = len(common) / max(len(kg), len(kc), 1)
    l0g = {k for k in kg if k[2] == 0}
    l0c = {k for k in kc if k[2] == 0}
    overlap0 = len(l0g & l0c) / max(len(l0g), len(l0c), 1)
    bits = [int(np.unpackbits((g.desc[kg[k]] ^ c.desc[kc[k]]).view(
        np.uint8)).sum()) for k in common]
    mean_ham = float(np.mean(bits)) if bits else float("inf")
    ok = (overlap >= KP_OVERLAP_MIN and overlap0 >= KP_OVERLAP_L0_MIN
          and mean_ham <= DESC_HAMMING_MAX)
    _line("parity_frontend", 0.0, run_s, "pass" if ok else "FAIL",
          keypoints_gpu=len(kg), keypoints_cpu=len(kc),
          overlap=f"{overlap:.4f}", overlap_level0=f"{overlap0:.4f}",
          mean_hamming_matched=f"{mean_ham:.3f}",
          max_hamming_matched=max(bits) if bits else None)
    assert ok, "frontend outside tolerance"


def phase_four_cards():
    """Distributed BA, sharded DB scoring and the engine's sharded
    detection on a 4-card mesh, each against its 1-card counterpart."""
    import jax
    import jax.numpy as jnp
    from orbslam2_tpu.config import CameraConfig, STEREO
    from orbslam2_tpu.models import keyframe_db as db_mod
    from orbslam2_tpu.models import map_state as M
    from orbslam2_tpu.models import vocabulary as voc_mod
    from orbslam2_tpu.parallel import db_shard, dist_ba, mesh as mesh_mod
    from orbslam2_tpu.runtime import loop_closing
    from orbslam2_tpu.utils import camera as cam_mod
    from tools.benchmarks.scaling import _problem

    devs = jax.devices()[:4]
    mesh4, mesh1 = mesh_mod.make_mesh(devs), mesh_mod.make_mesh(devs[:1])

    # ---- distributed BA at the __graft_entry__ shapes
    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0)
    cam = cam_mod.Camera.from_config(cam_cfg)
    C, P, per_cam = 64, 8192, 512
    prob = _problem(cam_cfg, C, per_cam, P)

    def ba(mesh):
        out = dist_ba.distributed_bundle_adjust(
            mesh, cam, prob, n_free=C, iters_a=5, iters_b=10,
            fix_first_free=True, solver="cg")
        return jax.block_until_ready(out)

    t0 = time.perf_counter()
    p1, p4 = np.asarray(ba(mesh1)[0]), np.asarray(ba(mesh4)[0])
    compile_s = time.perf_counter() - t0
    t1, t4 = _timed(lambda: ba(mesh1)[0], 5), _timed(lambda: ba(mesh4)[0], 5)
    err = float(np.max(np.abs(p1 - p4)))
    ok = bool(np.all(np.isfinite(p4))) and err <= BA_POSE_ATOL
    _line("four_cards_ba", compile_s, t1 + t4, "pass" if ok else "FAIL",
          cameras=C, points=P, observations=C * per_cam,
          max_pose_diff=f"{err:.2e}", step_ms_1card=f"{t1 * 1e3:.3f}",
          step_ms_4cards=f"{t4 * 1e3:.3f}")
    assert ok, f"4-card BA differs from 1-card by {err}"

    # ---- sharded loop-candidate scoring vs the unsharded query
    cfg = _cfg(STEREO)
    voc = voc_mod.default_vocabulary()
    K, W = cfg.capacity.max_keyframes, voc.n_words
    rng = np.random.default_rng(5)
    bow = rng.random((K, W)).astype(np.float32)
    bow /= np.linalg.norm(bow, axis=1, keepdims=True)
    db = db_mod.KeyFrameDB(bow=jnp.asarray(bow), valid=jnp.ones(K, bool))
    ms = M.empty_map(cfg)._replace(kf_valid=jnp.asarray(rng.random(K) < .9))
    q = jnp.asarray(bow[3] + 0.1 * rng.random(W).astype(np.float32))
    args = (ms, q, jnp.int32(-1), jnp.float32(0.0), 8)
    t0 = time.perf_counter()
    c1, s1 = db_mod.detect_candidates(db, *args)
    db4 = db_shard.shard_db(mesh4, db)
    c4, s4 = db_shard.detect_candidates_sharded(mesh4, db4, *args)
    run_s = time.perf_counter() - t0
    shard_devs = {s.device for s in db4.bow.addressable_shards}
    same = np.array_equal(np.asarray(c1), np.asarray(c4))
    ok = same and len(shard_devs) == 4
    _line("four_cards_db", 0.0, run_s, "pass" if ok else "FAIL",
          keyframes=K, words=W, same_candidates=same,
          shard_devices=len(shard_devs))
    assert ok, "sharded DB scoring differs or is not spread"

    # ---- the engine's detection step with its DB staying sharded
    lc = loop_closing.LoopCloser(cfg, voc)
    dense_step = loop_closing.make_loop_fns(cfg, voc)[-1]
    N = cfg.orb.n_features_padded
    ms_lc = ms._replace(
        kf_desc=jnp.asarray(rng.integers(0, 2 ** 32, (K, N, 8),
                                         dtype=np.uint32)),
        kf_kp_valid=jnp.asarray(rng.random((K, N)) < 0.9),
        kf_valid=jnp.ones(K, bool))
    db_dense = db_mod.KeyFrameDB.empty(K, W)
    t0 = time.perf_counter()
    same = True
    for k in range(6):
        lc.db, _, info_s = lc.f_detect_step(ms_lc, lc.db, jnp.int32(k))
        db_dense, _, info_d = dense_step(ms_lc, db_dense, jnp.int32(k))
        same &= np.array_equal(np.asarray(info_s[:, 0]),
                               np.asarray(info_d[:, 0]))
    run_s = time.perf_counter() - t0
    sharded = (lc.mesh is not None
               and not lc.db.bow.sharding.is_fully_replicated
               and len({s.device for s in lc.db.bow.addressable_shards}) == 4)
    ok = same and sharded
    _line("four_cards_detect", 0.0, run_s, "pass" if ok else "FAIL",
          same_as_dense=same, db_sharded=sharded)
    assert ok, "engine detection step differs or its DB is not sharded"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, on four cards")
    a = ap.parse_args(argv)
    n_cards = 4 if a.four_cards else 1
    if not a.four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax
    require_gpus(n_cards)

    sys.path.insert(0, ROOT)
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    failed = []

    def run(name, fn, *args):
        try:
            return fn(*args)
        except Exception:                      # report, then go on
            traceback.print_exc()
            print(f"phase {name}: FAIL", flush=True)
            failed.append(name)

    device = run("identity", print_identity)
    if a.four_cards:
        run("four_cards", phase_four_cards)
    else:
        world, poses, frames = stereo_sequence(FRAMES)
        run("stereo_system", phase_stereo_system, poses, frames)
        run("stereo_windowed", phase_stereo_windowed, world, poses, frames)
        run("mono_system", phase_mono_system, world)
        run("rgbd_system", phase_rgbd_system, world)
        run("loop_closure", phase_loop_closure)
        run("parity", phase_parity, frames)
    if failed or device is None:
        sys.exit(f"chip_smoke: failed phases: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
