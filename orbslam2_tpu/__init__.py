"""orbslam2_tpu — visual SLAM written as JAX programs.

A from-scratch re-design of the capabilities of ORB-SLAM2
(fabrizioromanelli fork) for an accelerator: the numerical core is
JAX/XLA, the map is array-structured functional state instead of a
pointer graph, and multi-chip scaling uses jax.sharding meshes instead of
threads+mutexes.

Layer map (mirrors reference SURVEY.md §1):
  utils/     — L-1 foundations: SE3/Sim3, camera model, config, datasets, IO
  ops/       — L2 kernels: ORB extraction, matching, stereo, RANSAC, BA
  models/    — L1 data model: Frame, array-structured Map, keyframe DB, BoW
  parallel/  — P6: sharded BA + DB scoring over device meshes
  runtime/   — L3/L4: tracking state machine, mapping, loop closing, System
"""

__version__ = "0.1.0"

import jax as _jax

# f32 matmuls/einsums run at full precision: on the H100 "highest" keeps
# f32 dots in full FP32 instead of TF32 (10-bit mantissa), which the LM
# normal equations and projection geometry need (a reduced-precision
# default lets long trajectories diverge).  The pixel-domain einsums opt back out to DEFAULT
# (TF32 here; parity in PERF.md), and the bf16 Hamming form passes bf16
# operands explicitly.  Respect an explicit user setting.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

from orbslam2_tpu.config import SlamConfig  # noqa: F401
