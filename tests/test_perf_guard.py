"""Guards against the device-constant capture pathology.

On some PJRT runtimes, compiling a jitted function that captured an
eagerly-created device array as a closure constant degraded *every*
subsequent dispatch.  Its cost on the H100 is not measured.  The rule:
anything captured by a jitted closure must be numpy; convert with
jnp.asarray only inside the trace.  These tests pin the rule for the
objects that are captured everywhere (Camera, sigma² tables).
"""

import numpy as np

import jax

from orbslam2_tpu.config import CameraConfig, OrbConfig, SlamConfig, STEREO
from orbslam2_tpu.runtime import tracking
from orbslam2_tpu.utils import camera as cam_mod


def _assert_host(x, name):
    assert not isinstance(x, jax.Array), (
        f"{name} is a device array; closure-captured constants must be "
        f"numpy (see tests/test_perf_guard.py docstring)")


def test_camera_fields_are_numpy():
    cam = cam_mod.Camera.from_config(CameraConfig(
        fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
        width=640, height=480, fps=30.0, th_depth=40.0))
    for f, v in cam._asdict().items():
        _assert_host(v, f"Camera.{f}")


def test_camera_fields_are_numpy_with_distortion():
    cam = cam_mod.Camera.from_config(CameraConfig(
        fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
        width=640, height=480, fps=30.0, th_depth=40.0,
        k1=-0.28, k2=0.07, p1=2e-4, p2=2e-5))
    for f, v in cam._asdict().items():
        _assert_host(v, f"Camera.{f}")
    # distorted bounds actually computed (not the defaults)
    assert float(cam.min_x) != 0.0 or float(cam.min_y) != 0.0


def test_sigma2_table_is_numpy():
    cfg = SlamConfig(camera=CameraConfig(
        fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=150.0,
        width=640, height=480, fps=30.0, th_depth=40.0),
        orb=OrbConfig(n_features=200), sensor=STEREO)
    t = tracking._sigma2_table(cfg)
    _assert_host(t, "sigma2 table")
    assert isinstance(t, np.ndarray)
