"""Configuration system mirroring the reference's YAML parameter surface.

The reference reads a single OpenCV ``cv::FileStorage`` YAML file carrying
camera intrinsics, ORB-extractor, tracking, loop-closing, optimizer, viewer,
and map-file keys (full surface documented in
``Config/RealSense-D435i-IRD.yaml``; read sites ``src/Tracking.cc:46-247``,
``src/Optimizer.cc:40-82``, ``src/LoopClosing.cc:46-70``).  The pattern is
"read key, fall back to a hard-coded default when absent/0" — we mirror both
the key names and those defaults here so any reference config file parses
unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# Sensor kinds — reference System.h:58 (eSensor MONOCULAR/STEREO/RGBD).
MONOCULAR = 0
STEREO = 1
RGBD = 2

SENSOR_NAMES = {MONOCULAR: "MONOCULAR", STEREO: "STEREO", RGBD: "RGBD"}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class CameraConfig:
    """Camera.* keys (reference Tracking.cc:48-130)."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0           # baseline × fx (stereo / RGB-D)
    fps: float = 30.0
    rgb: int = 1              # color order; 1=RGB 0=BGR
    width: int = 640
    height: int = 480
    th_depth: float = 35.0    # close/far point threshold, scaled by bf/fx
    depth_map_factor: float = 1.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclass(frozen=True)
class OrbConfig:
    """ORBextractor.* keys (reference Tracking.cc:132-158, ORBextractor.cc:405)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19

    @property
    def n_features_padded(self) -> int:
        """Feature capacity rounded up to a multiple of 256 (static shapes)."""
        return _round_up(self.n_features, 256)


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking.* keys — the fork's 27 tunables (Tracking.cc:160-216)."""

    min_frames: int = 0
    reference_keyframe_nn_ratio: float = 0.7
    min_matches_ref_keyframe: int = 15
    keyframe_tracking_threshold: int = 10
    points_closer_threshold: int = 100
    motion_model_nn_ratio: float = 0.9
    stereo_searching_radius: float = 15.0
    searching_radius: float = 7.0
    speedup_matches_threshold: int = 20
    speedup_matches_threshold2: int = 20
    motion_model_threshold: int = 10
    local_map_tracking_threshold: int = 30
    local_map_tracking_threshold2: int = 50
    new_keyframe_threshold: int = 100
    cosine_delta: float = 0.5
    search_local_points_nn_ratio: float = 0.8
    rgbd_searching_radius_threshold: float = 3.0
    searching_by_projection_threshold: float = 5.0
    keyframes_limit: int = 80
    relocalization_nn_ratio: float = 0.75
    keyframe_candidate_threshold: int = 15
    pnp_ransac_probability: float = 0.99
    pnp_ransac_min_inliers: int = 10
    pnp_ransac_max_iterations: int = 300
    pnp_ransac_min_set: int = 4
    pnp_ransac_epsilon: float = 0.5
    pnp_ransac_th2: float = 5.991
    p4p_relocalization_nn_ratio: float = 0.9
    ransac_iterations_relocalization: int = 5


@dataclass(frozen=True)
class LoopClosingConfig:
    """LoopClosing.* keys (LoopClosing.cc:46-70)."""

    covisibility_consistency_threshold: int = 3
    minimum_keyframes: int = 10
    sim3_nn_ratio: float = 0.75
    ransac_threshold_trigger: int = 20
    ransac_probability: float = 0.99
    ransac_minimal_inliers: int = 20
    ransac_max_iterations: int = 300
    detection_threshold: int = 40


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer.* keys (Optimizer.cc:40-82)."""

    huber_2d: float = 5.99      # chi² 95% 2-dof → delta = sqrt(5.99)
    huber_3d: float = 7.815     # chi² 95% 3-dof
    initial_lambda: float = 1e-16
    covisible_keyframes: int = 100   # essential-graph covisibility weight floor
    essential_graph_iterations: int = 20
    sim3_iterations: int = 5
    additional_iterations: int = 10
    additional_iterations_no_outliers: int = 5
    minimum_inliers_before_fail: int = 10


@dataclass(frozen=True)
class ViewerConfig:
    """Viewer.* keys (Viewer.cc:38-52) — kept for config parity."""

    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.1
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0


@dataclass(frozen=True)
class CapacityConfig:
    """Static device-array capacities (no reference analogue: the reference's
    pointer graph grows unboundedly; we use fixed-capacity device arrays with
    liveness masks, per SURVEY.md §7)."""

    max_keyframes: int = 512
    max_map_points: int = 1 << 15          # 32768
    local_ba_keyframes: int = 32           # local window cap (bucketed)
    local_ba_points: int = 4096
    reloc_candidates: int = 8
    loop_candidates: int = 8
    # stage-2 tracking matches against a compacted top-C candidate set
    # instead of all P map points (the reference's frustum+grid pruning,
    # Tracking::SearchLocalPoints) — bounds the per-frame Hamming matrix
    track_candidates: int = 4096
    # SearchInNeighbors fuse candidate pool: the covisible
    # neighbourhood's in-frustum points, compacted before the [C, N]
    # matcher.  Local neighbourhoods run 1-3k points at the eval scales;
    # 2048 halves the fuse matcher traffic (the reference fuses against
    # every neighbourhood point — bounded here like local_ba_points)
    fuse_candidates: int = 2048
    # covisible neighbours searched by CreateNewMapPoints
    # (LocalMapping.cc:211: nn=10 stereo/RGBD, 20 mono)
    triangulation_neighbors: int = 10
    # KeyFrameCulling victims per pass (the reference loops until no more
    # are redundant; we bound per-insert work and converge over frames)
    kf_cull_victims: int = 2
    grid_cols: int = 64                    # Frame.h FRAME_GRID_COLS
    grid_rows: int = 48                    # Frame.h FRAME_GRID_ROWS
    # BoW tree: k^levels words.  10⁴ matches the reference vocabulary's
    # discrimination at ≤512-KF map scale while keeping keyframe-DB
    # scoring a dense [K, W] matvec (models/vocabulary.py rationale)
    vocab_levels: int = 4
    vocab_k: int = 10


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    loop: LoopClosingConfig = field(default_factory=LoopClosingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    sensor: int = STEREO
    map_file: str = ""

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------- YAML --
    @staticmethod
    def from_yaml(path: str, sensor: int = STEREO) -> "SlamConfig":
        """Parse an (OpenCV-style) YAML settings file.

        Handles the ``%YAML:1.0`` directive header that PyYAML rejects, and
        the flat dotted-key namespace the reference uses.
        """
        with open(path, "r") as f:
            text = f.read()
        return SlamConfig.from_yaml_str(text, sensor=sensor)

    @staticmethod
    def from_yaml_str(text: str, sensor: int = STEREO) -> "SlamConfig":
        flat = _parse_opencv_yaml(text)
        return SlamConfig.from_flat_dict(flat, sensor=sensor)

    @staticmethod
    def from_flat_dict(flat: Dict[str, Any], sensor: int = STEREO) -> "SlamConfig":
        g = _Getter(flat)
        cam = CameraConfig(
            fx=g.f("Camera.fx", 500.0), fy=g.f("Camera.fy", 500.0),
            cx=g.f("Camera.cx", 320.0), cy=g.f("Camera.cy", 240.0),
            k1=g.f("Camera.k1", 0.0), k2=g.f("Camera.k2", 0.0),
            p1=g.f("Camera.p1", 0.0), p2=g.f("Camera.p2", 0.0),
            k3=g.f("Camera.k3", 0.0),
            bf=g.f("Camera.bf", 0.0),
            fps=g.f("Camera.fps", 30.0) or 30.0,
            rgb=g.i("Camera.RGB", 1),
            width=g.i("Camera.width", 640), height=g.i("Camera.height", 480),
            th_depth=g.f("ThDepth", 35.0),
            depth_map_factor=g.f("DepthMapFactor", 1.0) or 1.0,
        )
        orb = OrbConfig(
            n_features=g.i("ORBextractor.nFeatures", 1000),
            scale_factor=g.f("ORBextractor.scaleFactor", 1.2),
            n_levels=g.i("ORBextractor.nLevels", 8),
            ini_th_fast=g.i("ORBextractor.iniThFAST", 20),
            min_th_fast=g.i("ORBextractor.minThFAST", 7),
            patch_size=g.i("ORBextractor.patchSize", 31),
            half_patch_size=g.i("ORBextractor.halfPatchSize", 15),
            edge_threshold=g.i("ORBextractor.edgeThreshold", 19),
        )
        trk = TrackingConfig(
            min_frames=g.i("Tracking.minFrames", 0),
            reference_keyframe_nn_ratio=g.f("Tracking.referenceKeyframeNnRatioOrbMatcher", 0.7),
            min_matches_ref_keyframe=g.i("Tracking.minimumMatchesRefKeyframe", 15),
            keyframe_tracking_threshold=g.i("Tracking.keyframeTrackingThreshold", 10),
            points_closer_threshold=g.i("Tracking.pointsCloserThreshold", 100),
            motion_model_nn_ratio=g.f("Tracking.motionModelNnRatioOrbMatcher", 0.9),
            stereo_searching_radius=g.f("Tracking.stereoSearchingRadius", 15.0),
            searching_radius=g.f("Tracking.searchingRadius", 7.0),
            speedup_matches_threshold=g.i("Tracking.speedupMatchesThreshold", 20),
            speedup_matches_threshold2=g.i("Tracking.speedupMatchesThreshold2", 20),
            motion_model_threshold=g.i("Tracking.motionModelThreshold", 10),
            local_map_tracking_threshold=g.i("Tracking.localMapTrackingThreshold", 30),
            local_map_tracking_threshold2=g.i("Tracking.localMapTrackingThreshold2", 50),
            new_keyframe_threshold=g.i("Tracking.newKeyframeThreshold", 100),
            cosine_delta=g.f("Tracking.cosineDelta", 0.5),
            search_local_points_nn_ratio=g.f("Tracking.searchLocalPointsNnRatioOrbMatcher", 0.8),
            rgbd_searching_radius_threshold=g.f("Tracking.RGBDSearchingRadiusThreshold", 3.0),
            searching_by_projection_threshold=g.f("Tracking.searchingByProjectionThreshold", 5.0),
            keyframes_limit=g.i("Tracking.keyframesLimit", 80),
            relocalization_nn_ratio=g.f("Tracking.relocalizationNnRatioOrbMatcher", 0.75),
            keyframe_candidate_threshold=g.i("Tracking.keyframeCandidateThreshold", 15),
            pnp_ransac_probability=g.f("Tracking.pnpSolverRansacProbability", 0.99),
            pnp_ransac_min_inliers=g.i("Tracking.pnpSolverRansacMinInliers", 10),
            pnp_ransac_max_iterations=g.i("Tracking.pnpSolverRansacMaxIterations", 300),
            pnp_ransac_min_set=g.i("Tracking.pnpSolverRansacMinSet", 4),
            pnp_ransac_epsilon=g.f("Tracking.pnpSolverRansacEpsilon", 0.5),
            pnp_ransac_th2=g.f("Tracking.pnpSolverRansacTh2", 5.991),
            p4p_relocalization_nn_ratio=g.f("Tracking.p4pRelocalizationNnRatioOrbMatcher", 0.9),
            ransac_iterations_relocalization=g.i("Tracking.ransacIterationsRelocalization", 5),
        )
        loop = LoopClosingConfig(
            covisibility_consistency_threshold=g.i("LoopClosing.covisibilityConsistencyThreshold", 3),
            minimum_keyframes=g.i("LoopClosing.minimumKeyFrames", 10),
            sim3_nn_ratio=g.f("LoopClosing.sim3nnRatioOrbMatcher", 0.75),
            ransac_threshold_trigger=g.i("LoopClosing.ransacThresholdTrigger", 20),
            ransac_probability=g.f("LoopClosing.ransacProbability", 0.99),
            ransac_minimal_inliers=g.i("LoopClosing.ransacMinimalInliers", 20),
            ransac_max_iterations=g.i("LoopClosing.ransacMaxIterations", 300),
            detection_threshold=g.i("LoopClosing.detectionThreshold", 40),
        )
        opt = OptimizerConfig(
            huber_2d=g.f("Optimizer.2DHuberThreshold", 5.99),
            huber_3d=g.f("Optimizer.3DHuberThreshold", 7.815),
            initial_lambda=g.f("Optimizer.initialLambda", 1e-16),
            covisible_keyframes=g.i("Optimizer.covisibleKeyframes", 100),
            essential_graph_iterations=g.i("Optimizer.essentialGraphIterations", 20),
            sim3_iterations=g.i("Optimizer.sim3Iterations", 5),
            additional_iterations=g.i("Optimizer.additionalIterations", 10),
            additional_iterations_no_outliers=g.i("Optimizer.additionalIterationsNoOutliers", 5),
            minimum_inliers_before_fail=g.i("Optimizer.minimumInliersBeforeFail", 10),
        )
        viewer = ViewerConfig(
            keyframe_size=g.f("Viewer.KeyFrameSize", 0.05),
            keyframe_line_width=g.f("Viewer.KeyFrameLineWidth", 1.0),
            graph_line_width=g.f("Viewer.GraphLineWidth", 0.9),
            point_size=g.f("Viewer.PointSize", 2.0),
            camera_size=g.f("Viewer.CameraSize", 0.1),
            camera_line_width=g.f("Viewer.CameraLineWidth", 3.0),
            viewpoint_x=g.f("Viewer.ViewpointX", 0.0),
            viewpoint_y=g.f("Viewer.ViewpointY", -0.7),
            viewpoint_z=g.f("Viewer.ViewpointZ", -1.8),
            viewpoint_f=g.f("Viewer.ViewpointF", 500.0),
        )
        return SlamConfig(
            camera=cam, orb=orb, tracking=trk, loop=loop, optimizer=opt,
            viewer=viewer, sensor=sensor,
            map_file=str(flat.get("Map.mapfile", "") or ""),
        )


class _Getter:
    """'Read key, fall back to default when absent or 0' — the reference's
    cv::FileStorage pattern (Tracking.cc:161-216)."""

    def __init__(self, flat: Dict[str, Any]):
        self.flat = flat

    def f(self, key: str, default: float) -> float:
        v = self.flat.get(key)
        if v is None:
            return float(default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return float(default)

    def i(self, key: str, default: int) -> int:
        return int(round(self.f(key, default)))


def _parse_opencv_yaml(text: str) -> Dict[str, Any]:
    """Parse OpenCV FileStorage YAML into a flat dict.

    PyYAML chokes on the ``%YAML:1.0`` directive; the files are otherwise a
    flat `key: value` list plus ``!!opencv-matrix`` blocks (the LEFT./RIGHT.
    rectification matrices of Stereo-EuRoC.yaml, stereo_euroc.cc:73-86) —
    matrices land in the dict as numpy [rows, cols] float64 arrays.
    """
    import numpy as _np

    flat: Dict[str, Any] = {}
    mat_key = None
    mat: Dict[str, Any] = {}
    data_open = False

    def close_matrix():
        nonlocal mat_key, mat, data_open
        if mat_key is not None and "data" in mat:
            arr = _np.asarray(mat["data"], _np.float64)
            flat[mat_key] = arr.reshape(int(mat.get("rows", 1)),
                                        int(mat.get("cols", arr.size)))
        mat_key, mat, data_open = None, {}, False

    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        if not line or line.lstrip().startswith("%"):
            continue
        if data_open:
            chunk = line.strip().rstrip(",")
            done = chunk.endswith("]")
            mat["data"] += [float(x) for x in
                            chunk.strip("[]").replace(",", " ").split() if x]
            if done:
                data_open = False
                close_matrix()
            continue
        m = re.match(r"^(\s*)([\w./]+)\s*:\s*(.*?)\s*$", line)
        if not m:
            continue
        indent, key, val = m.group(1), m.group(2), m.group(3)
        if mat_key is not None and indent:
            if key in ("rows", "cols"):
                mat[key] = int(val)
            elif key == "dt":
                pass
            elif key == "data":
                body = val.strip()
                vals = [float(x) for x in
                        body.strip("[]").replace(",", " ").split() if x]
                mat["data"] = vals
                if not body.endswith("]"):
                    data_open = True
                else:
                    close_matrix()
            continue
        if mat_key is not None:
            close_matrix()
        if val.startswith("!!opencv-matrix"):
            mat_key, mat = key, {}
            continue
        if not val:
            continue
        if re.fullmatch(r"[-+]?\d+", val):
            flat[key] = int(val)
        else:
            try:
                flat[key] = float(val)
            except ValueError:
                flat[key] = val.strip('"')
    close_matrix()
    return flat
