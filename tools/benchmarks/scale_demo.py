"""Map-scale demonstration (VERDICT r4 next #4): a loop-rich circuit of
thousands of frames at >=1024-keyframe / 1e5-map-point capacity.

Drives the windowed engine around a rounded-rectangle tour of a closed
room (utils/synthetic.room_world + circuit_trajectory), logging the
fps-vs-map-size curve, keyframe/point growth, loop closures (the
circuit returns to its start late in the run), GBA latency at large K,
and device memory.  Writes SCALE.md + one JSON line.

Usage: python tools/benchmarks/scale_demo.py [n_frames] [--laps 1.15]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", nargs="?", type=int, default=2400)
    ap.add_argument("--laps", type=float, default=1.15)
    ap.add_argument("--max-kf", type=int, default=1024)
    ap.add_argument("--max-mp", type=int, default=1 << 17)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()

    import jax
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from orbslam2_tpu.config import (CameraConfig, CapacityConfig,
                                     OrbConfig, STEREO, SlamConfig)
    from orbslam2_tpu.runtime.windowed import WindowedSlamEngine
    from orbslam2_tpu.utils import synthetic

    cfg = SlamConfig(
        camera=CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0,
                            bf=120.0, width=320, height=240, fps=10.0,
                            th_depth=35.0),
        orb=OrbConfig(n_features=1000),
        capacity=CapacityConfig(max_keyframes=a.max_kf,
                                max_map_points=a.max_mp,
                                local_ba_keyframes=8,
                                local_ba_points=2048),
        sensor=STEREO)

    rng = np.random.default_rng(7)
    world = synthetic.room_world(rng, half=60.0, tex_size=2048)
    # texture period 2048/17 = 120 m >= wall length: no repetition to
    # alias place recognition; 17 px/m keeps FAST-scale contrast at the
    # 3-10 m viewing distances (the 7 px/m first cut starved the
    # extractor to ~50 features/frame and even the cv2 oracle lost
    # tracking at the first corner)
    for pl in world.planes:
        pl.scale = 17.0
    # view angled toward the outer wall and down at the ground: the
    # pure-tangent view faces walls beyond stereo range in a 120 m room
    # (first validation run lost tracking at the first corner)
    poses = synthetic.circuit_trajectory(a.n_frames, half=55.0,
                                         corner=12.0, laps=a.laps,
                                         yaw_out=0.45, pitch=-0.2)

    print(f"rendering {a.n_frames} stereo pairs ...", flush=True)
    t0 = time.perf_counter()
    frames = [synthetic.render_world_stereo(world, cfg.camera, T, rng,
                                            noise=1.0) for T in poses]
    print(f"  {time.perf_counter()-t0:.0f}s", flush=True)

    eng = WindowedSlamEngine(cfg, enable_loop_closing=True,
                             window=a.window)
    t0 = time.perf_counter()
    eng.prewarm()
    print(f"prewarm: {time.perf_counter()-t0:.0f}s", flush=True)

    chunk = 200
    curve = []
    gba_before = 0
    t_start = time.perf_counter()
    for c0 in range(0, a.n_frames, chunk):
        t0 = time.perf_counter()
        for i in range(c0, min(c0 + chunk, a.n_frames)):
            eng.track_stereo(*frames[i], timestamp=0.1 * i)
        eng.flush()
        dt = time.perf_counter() - t0
        mem = None
        try:
            st = jax.local_devices()[0].memory_stats()
            mem = round(st.get("bytes_in_use", 0) / 1e6)
        except Exception:
            pass
        row = {
            "frames": min(c0 + chunk, a.n_frames),
            "fps": round(min(chunk, a.n_frames - c0) / dt, 2),
            "n_kfs": eng.n_kfs,
            "live_points": eng.n_live_points,
            "kf_inserted": eng.stats["kf_inserted"],
            "kf_culled": eng.stats["kf_culled"],
            "loops": eng.stats.get("loops_closed", 0),
            "state": eng.state,
            "mem_MB": mem,
        }
        curve.append(row)
        print(row, flush=True)
    wall = time.perf_counter() - t_start

    # drain any background GBA and time it from here
    t0 = time.perf_counter()
    eng.finish_gba()
    gba_drain = time.perf_counter() - t0

    tracked = sum(p is not None for p in eng.frame_poses())
    # ATE vs ground truth (stereo metric scale; gt rebased so camera 0 is
    # the origin — the engine's world frame IS the first camera)
    T0inv = np.linalg.inv(poses[0])
    poses_rel = [T @ T0inv for T in poses]
    errs = []
    for Te, Tg in zip(eng.frame_poses(), poses_rel):
        if Te is None:
            continue
        Ce = -Te[:3, :3].T @ Te[:3, 3]
        Cg = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.sum((Ce - Cg) ** 2))
    ate = float(np.sqrt(np.mean(errs))) if errs else float("nan")

    first_fps = np.median([r["fps"] for r in curve[:3]])
    last_fps = np.median([r["fps"] for r in curve[-3:]])
    summary = {
        "metric": "scale_demo",
        "n_frames": a.n_frames,
        "capacity_kf": a.max_kf,
        "capacity_mp": a.max_mp,
        "wall_s": round(wall, 1),
        "overall_fps": round(a.n_frames / wall, 2),
        "fps_first3_chunks": round(float(first_fps), 2),
        "fps_last3_chunks": round(float(last_fps), 2),
        "fps_degradation": round(float(first_fps / max(last_fps, 1e-9)), 3),
        "peak_kfs": max(r["n_kfs"] for r in curve),
        "peak_points": max(r["live_points"] for r in curve),
        "loops_closed": curve[-1]["loops"],
        "kf_evicted": eng.stats.get("kf_evicted", 0),
        "gba_runs": eng.loop_closer.gba.stats.get("finished", 0)
        if eng.loop_closer else 0,
        "gba_drain_s": round(gba_drain, 1),
        "tracked_frames": tracked,
        "ate_m": round(ate, 3),
        "mem_MB_last": curve[-1]["mem_MB"],
    }
    print(json.dumps(summary))

    out = a.out or os.path.join(os.path.dirname(__file__), "..", "..",
                                "SCALE.md")
    with open(out, "w") as f:
        f.write("# Map-scale demonstration\n\n")
        f.write(f"Circuit: {a.n_frames} frames, {a.laps} laps of a "
                "rounded-rectangle tour (~420 m/lap) in a closed room; "
                f"capacity {a.max_kf} keyframes / {a.max_mp} map points; "
                "loop closing + background GBA on.  Generated by "
                "`tools/benchmarks/scale_demo.py` on "
                f"{jax.devices()[0].device_kind}.\n\n")
        f.write("| frames | fps | keyframes | points | culled | loops |"
                " mem MB |\n|---|---|---|---|---|---|---|\n")
        for r in curve:
            f.write(f"| {r['frames']} | {r['fps']} | {r['n_kfs']} | "
                    f"{r['live_points']} | {r['kf_culled']} | "
                    f"{r['loops']} | {r['mem_MB']} |\n")
        f.write("\n```json\n" + json.dumps(summary, indent=2) + "\n```\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
