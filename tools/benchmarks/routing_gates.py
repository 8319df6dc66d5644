"""Times both sides of the two shape-routed choices on the device.

* Hamming distance (ops/hamming.py, ``MATMUL_FORM_MIN_PAIRS``): the bf16
  matmul form against the popcount word loop, each followed by the
  matchers' best/second reduction, at the projection matcher's
  [track_candidates × N] and at 1024 × 1024.
* BA segment sums (ops/bundle.py, ``ONEHOT_MAX_PAIRS``): one-hot matmuls
  against scatter-adds, in a whole dense-solver local BA at the bench
  configuration's shape (8 free + 8 fixed keyframes × 1024 features,
  2048 points, 5 + 10 LM iterations).

Prints the device identity, one line per timing (median wall ms of
20 calls ending in ``block_until_ready``), and the results as JSON.

Run: python tools/benchmarks/routing_gates.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def _median_ms(fn, *args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import print_identity, require_gpus
    require_gpus(1)
    from orbslam2_tpu.config import CameraConfig, CapacityConfig, OrbConfig
    from orbslam2_tpu.ops import bundle, hamming, matching
    from orbslam2_tpu.utils import camera as cam_mod
    from orbslam2_tpu.utils.compile_cache import enable_compile_cache
    from tools.benchmarks.scaling import _problem
    enable_compile_cache()
    print_identity()

    out = {}
    rng = np.random.default_rng(0)
    N = OrbConfig(n_features=1000).n_features_padded
    P = CapacityConfig().track_candidates
    forms = {"matmul": hamming.hamming_matrix_matmul,
             "popcount": hamming.hamming_matrix_popcount}
    for A, B in ((P, N), (1024, 1024)):
        a = jnp.asarray(rng.integers(0, 2 ** 32, (A, 8), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32))
        for name, form in forms.items():
            ms = _median_ms(jax.jit(
                lambda a, b, f=form: matching.best_and_second(f(a, b))), a, b)
            key = f"hamming_{name}_top2_{A}x{B}_ms"
            out[key] = ms
            print(f"{key}={ms:.4f}", flush=True)

    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0)
    cam = cam_mod.Camera.from_config(cam_cfg)
    prob = _problem(cam_cfg, 16, N, 2048)
    default_gate = bundle.ONEHOT_MAX_PAIRS
    for name, gate in (("onehot", default_gate), ("scatter", 0)):
        bundle.ONEHOT_MAX_PAIRS = gate        # read when the BA is traced
        try:
            f = jax.jit(lambda p: bundle.bundle_adjust(
                cam, p, n_free=8, iters_a=5, iters_b=10)[0])
            ms = _median_ms(f, prob)
        finally:
            bundle.ONEHOT_MAX_PAIRS = default_gate
        key = f"local_ba_{name}_ms"
        out[key] = ms
        print(f"{key}={ms:.4f}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
