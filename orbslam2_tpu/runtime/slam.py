"""Host-side SLAM engine: wires frontend + tracking + local mapping.

This is the control-plane analogue of ``Tracking::Track`` (Tracking.cc:366)
plus the LocalMapping loop — the data-dependent decisions (state machine,
fallbacks, keyframe policy) read back a handful of scalars per frame while
all array work stays in jitted functions on device.

Dispatch discipline: every dispatch and device→host fetch costs host
latency, so the steady-state contract is

  * ONE fused dispatch + ONE 40-float fetch per tracked frame
    (tracking.make_fused_track_fn: uint8 upload → frontend → two-stage
    track with in-device widen → counter fold), and
  * ONE fused dispatch + ONE small stats fetch per keyframe insertion
    (local_mapping.make_mapping_step: insert → cull → triangulate top-k
    neighbours → fuse → local BA → KF cull).

The reference runs LocalMapping in its own thread with a keyframe queue
(System.cc:104, LocalMapping.cc:114); here mapping runs synchronously after
keyframe insertion by default, with the async path provided by
runtime/pipeline.py.

Keyframe and map-point rows are REUSED after culling (slot free-lists /
device-side allocator) — capacity bounds live entities, not entities ever
created.  Trajectory entries whose reference keyframe is culled are rebased
onto its spanning-tree parent with the relative pose at cull time, exactly
like the reference's mTcp walk in SaveTrajectoryTUM (System.cc:478-503,
KeyFrame.cc:533).
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import MONOCULAR, RGBD, STEREO, SlamConfig
from orbslam2_tpu.models import frame as frame_mod
from orbslam2_tpu.models import map_state as M
from orbslam2_tpu.runtime import local_mapping, tracking
from orbslam2_tpu.utils import lie


@dataclasses.dataclass
class TrajectoryEntry:
    """Per-frame relative pose record (Tracking.cc:588-605): Tcr = pose
    relative to the reference keyframe at track time, so trajectory export
    benefits from later keyframe corrections (System.cc:478-503)."""

    timestamp: float
    Tcr: np.ndarray
    ref_kf: int
    lost: bool


class SlamEngine:
    """Single-process engine for stereo / RGB-D / monocular sequences."""

    def __init__(self, cfg: SlamConfig, enable_loop_closing: bool = True,
                 vocabulary=None):
        self.cfg = cfg
        if cfg.sensor == STEREO:
            self.frontend = frame_mod.make_frontend_stereo(cfg)
        elif cfg.sensor == RGBD:
            self.frontend = frame_mod.make_frontend_rgbd(cfg)
        else:
            self.frontend = frame_mod.make_frontend_mono(cfg)
        self.fns = tracking.make_tracking_fns(cfg)
        self.f_track = self.fns.track
        self.f_track_ref = self.fns.track_ref_kf
        self.f_pose_cov = self.fns.pose_covariance
        self.f_apply_counters = self.fns.apply_counters
        self.f_init = self.fns.init_stereo
        (self.f_track_frame,
         self.f_track_frame_loc) = tracking.make_fused_track_fn(cfg)
        self.f_mapping_step = local_mapping.make_mapping_step(cfg)
        self.loop_closer = None
        if enable_loop_closing:
            from orbslam2_tpu.models.vocabulary import default_vocabulary
            from orbslam2_tpu.runtime.loop_closing import LoopCloser
            voc = vocabulary if vocabulary is not None else \
                default_vocabulary(k=cfg.capacity.vocab_k,
                                   levels=cfg.capacity.vocab_levels)
            self.loop_closer = LoopCloser(cfg, voc)

        self.ms = M.empty_map(cfg)
        self.state = tracking.NO_IMAGES_YET
        self.n_kfs = 0                # LIVE keyframes
        self.kf_ordinal = 0           # keyframes ever inserted (monotonic)
        self.n_live_points = 0
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self.velocity: Optional[np.ndarray] = None
        self.last_Tcw: Optional[np.ndarray] = None
        self.last_assoc = None        # device [N] int32
        self.last_inlier = None       # device [N] bool
        self.trajectory: List[TrajectoryEntry] = []
        self.localization_only = False
        self._free_kf_slots = set(range(cfg.capacity.max_keyframes))
        self._capacity_warned = False
        self._zeros_p = jnp.zeros((cfg.capacity.max_map_points,), jnp.int32)
        self._traj_lock = threading.Lock()
        self._culled_remap = {}       # victim slot → (parent slot, Tcp)
        self.stats = {"kf_inserted": 0, "mp_created": 0, "mp_culled": 0,
                      "kf_culled": 0, "ba_outliers": 0, "reloc": 0,
                      "mp_fused": 0, "loops_closed": 0}

    # ------------------------------------------------------------- prewarm
    def prewarm(self, localization: bool = False) -> None:
        """Compile every steady-state program variant once, against the
        CURRENT map state (zero-valued dummy frames; shapes are static so
        values are irrelevant).  Without this, the rare paths — per-frame
        fallback tracking, TrackReferenceKeyFrame, relocalization, the
        per-frame mapping step — compile mid-sequence on their first LOST
        window, stalling the pipeline for tens of seconds.  The reference
        has no equivalent because C++ has no JIT; this is the JIT analogue
        of its warm start."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        if self.cfg.sensor == STEREO:
            pay = np.zeros(2 * H * W, np.uint8)
        elif self.cfg.sensor == RGBD:
            pay = (np.zeros(H * W, np.uint8), np.zeros(H * W, np.float32))
        else:
            pay = np.zeros(H * W, np.uint8)
        ms = self.ms
        N = self.cfg.orb.n_features_padded
        assoc = jnp.full((N,), M.NO_MP, jnp.int32)
        okv = jnp.ones((N,), bool)
        eye = jnp.eye(4, dtype=jnp.float32)
        k0 = jnp.int32(0)
        ms2, fd, res = self.f_track_frame(ms, pay, eye, assoc, okv, k0)
        self.f_track_ref(ms, fd, k0, eye)
        self.f_track(ms, fd, eye, assoc, okv, k0)
        self.f_apply_counters(ms, res.visible_mask, res.found_mask)
        zp = self._zeros_p
        _ms3, _stats = self.f_mapping_step(
            ms, fd, eye, assoc, k0, k0, jnp.int32(-1), k0, jnp.float32(0.0),
            jnp.bool_(True), jnp.bool_(True), zp, zp)
        if localization:
            self.f_track_frame_loc(ms, pay, fd, eye, eye, assoc, okv, k0)
        if self.loop_closer is not None:
            self.loop_closer.prewarm(ms)
            self.loop_closer.prewarm_reloc(ms, fd)
        jax.block_until_ready(_stats)

    # --------------------------------------------------------- frame entry
    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> Optional[np.ndarray]:
        self._last_image = left          # FrameDrawer source (mImGray)
        pay = np.concatenate([
            np.ascontiguousarray(left, dtype=np.uint8).reshape(-1),
            np.ascontiguousarray(right, dtype=np.uint8).reshape(-1)])
        return self._track_common(pay, timestamp)

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray,
                   timestamp: float) -> Optional[np.ndarray]:
        self._last_image = gray
        pay = (np.ascontiguousarray(gray, dtype=np.uint8).reshape(-1),
               np.ascontiguousarray(depth, dtype=np.float32).reshape(-1))
        return self._track_common(pay, timestamp)

    def track_monocular(self, gray, timestamp: float):
        self._last_image = gray
        pay = np.ascontiguousarray(gray, dtype=np.uint8).reshape(-1)
        return self._track_common(pay, timestamp)

    # ----------------------------------------------------- frame overlay
    def _overlay_data(self):
        """(xy_raw [N,2], valid [N], matched [N]) of the latest tracked
        frame, or None before the first frame."""
        fd = getattr(self, "last_fd", None)
        if fd is None or self.last_assoc is None:
            return None
        matched = (np.asarray(self.last_assoc) >= 0)
        if self.last_inlier is not None:
            matched &= np.asarray(self.last_inlier)
        return np.asarray(fd.xy_raw), np.asarray(fd.valid), matched

    def frame_overlay(self) -> Optional[bytes]:
        """FrameDrawer::DrawFrame analogue (src/FrameDrawer.cc:34-206):
        the current gray frame annotated with keypoints (green = tracked
        map-point inlier, red = unmatched) and the state text line,
        encoded as PNG.  Composed lazily — the live viewer calls this at
        its own poll rate, so the tracking hot path never pays for it."""
        import io

        from PIL import Image, ImageDraw
        img = getattr(self, "_last_image", None)
        ov = self._overlay_data()
        if img is None or ov is None:
            return None
        xy, valid, matched = ov
        im = Image.fromarray(np.clip(np.asarray(img), 0,
                                     255).astype(np.uint8)).convert("RGB")
        d = ImageDraw.Draw(im)
        n_match = 0
        for i in range(len(xy)):
            if not valid[i]:
                continue
            x, y = float(xy[i, 0]), float(xy[i, 1])
            if matched[i]:
                n_match += 1
                d.rectangle([x - 3, y - 3, x + 3, y + 3],
                            outline=(0, 255, 0))
            else:
                d.ellipse([x - 1.5, y - 1.5, x + 1.5, y + 1.5],
                          outline=(255, 80, 80))
        if self.state == tracking.LOST:
            text = "TRYING TO RELOCALIZE"
        elif self.state != tracking.OK:
            text = "WAITING FOR IMAGES" if self.state < 1 \
                else "TRYING TO INITIALIZE"
        else:
            mode = ("LOCALIZATION" if self.localization_only else
                    "SLAM MODE")
            text = (f"{mode} | KFs: {self.n_kfs}, MPs: "
                    f"{self.n_live_points}, Matches: {n_match}")
        d.rectangle([0, im.height - 18, im.width, im.height],
                    fill=(30, 30, 30))
        d.text((6, im.height - 15), text, fill=(255, 255, 0))
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        return buf.getvalue()

    def _decode(self, pay) -> frame_mod.FrameData:
        """Frontend for the rare host-decoded paths (init, reloc)."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        if self.cfg.sensor == STEREO:
            imgs = pay.reshape(2, H, W).astype(np.float32)
            return self.frontend(jnp.asarray(imgs[0]), jnp.asarray(imgs[1]))
        if self.cfg.sensor == RGBD:
            gray, depth = pay
            return self.frontend(
                jnp.asarray(gray.reshape(H, W).astype(np.float32)),
                jnp.asarray(depth.reshape(H, W)))
        return self.frontend(jnp.asarray(pay.reshape(H, W).astype(np.float32)))

    # ------------------------------------------------------------ tracking
    def _track_common(self, pay, timestamp: float) -> Optional[np.ndarray]:
        # auto-reset when lost soon after initialization (Tracking.cc:
        # 571-580: LOST with ≤5 keyframes → full system reset; a bad
        # bootstrap map would otherwise pin the engine LOST forever)
        if (self.state == tracking.LOST and not self.localization_only
                and self.n_kfs <= 5):
            self._auto_reset()
        if self.state in (tracking.NO_IMAGES_YET, tracking.NOT_INITIALIZED):
            fd = self._decode(pay)
            ok = self._initialize(fd, timestamp)
            self.frame_id += 1
            return np.asarray(self.last_Tcw) if ok else None

        if self.state == tracking.LOST:
            fd = self._decode(pay)
            return self._handle_lost(fd, timestamp)

        t = self.cfg.tracking
        Tcw_pred = self._predict_pose()
        # capture ONE consistent (map snapshot, reference-KF id) pair for
        # the whole frame: in the async engine the mapping worker swaps
        # both concurrently, and mixing a Tcr computed against the old ref
        # with the new ref id corrupts the reconstructed trajectory
        ms = self.ms
        ref_at_track = self.ref_kf
        ref_kf = jnp.int32(ref_at_track)
        # localization mode on a depth sensor: temporal VO points + mbVO
        # dual path (Tracking.cc:393-520, 901-965)
        use_vo = (self.localization_only and self.cfg.sensor != MONOCULAR
                  and getattr(self, "last_fd", None) is not None)
        if use_vo:
            ms2, fd, res = self.f_track_frame_loc(
                ms, pay, self.last_fd,
                jnp.asarray(self.last_Tcw, jnp.float32),
                jnp.asarray(Tcw_pred, jnp.float32),
                self.last_assoc, self.last_inlier, ref_kf)
            sm = tracking.Summary(np.asarray(res.summary))
            return self._finish_loc_frame(ms2, fd, res, sm, pay,
                                          ref_at_track, timestamp)
        ms2, fd, res = self.f_track_frame(
            ms, pay, jnp.asarray(Tcw_pred, jnp.float32),
            self.last_assoc, self.last_inlier, ref_kf)
        # ONE device→host fetch per frame: everything the state machine
        # needs is packed in res.summary
        sm = tracking.Summary(np.asarray(res.summary))
        counters_folded = True
        if sm.n_inliers_map < t.local_map_tracking_threshold:
            # motion model failed → TrackReferenceKeyFrame (Tracking.cc:419),
            # then re-run the full two-stage track from the recovered pose
            ref = self.f_track_ref(
                ms, fd, ref_kf, jnp.asarray(self.last_Tcw, jnp.float32))
            sm_ref = tracking.Summary(np.asarray(ref.summary))
            if sm_ref.n_matches_mm >= t.min_matches_ref_keyframe:
                res2 = self.f_track(ms, fd, ref.Tcw, ref.assoc,
                                    ref.inlier, ref_kf)
                sm2 = tracking.Summary(np.asarray(res2.summary))
                if sm2.n_inliers_map > sm.n_inliers_map:
                    res, sm = res2, sm2
                    counters_folded = False

        n_map_inliers = sm.n_inliers_map
        self._absorb_track(ms2 if counters_folded else None, res)
        # TrackLocalMap acceptance (Tracking.cc:1060-1072)
        lost = n_map_inliers < t.local_map_tracking_threshold
        if lost:
            self.state = tracking.LOST
            self.velocity = None
            self._record_traj(timestamp, None)
            self.frame_id += 1
            return None

        self.state = tracking.OK
        Tcw = sm.Tcw
        if self.last_Tcw is not None:
            self.velocity = Tcw @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = Tcw
        self._last_Tcw_dev = res.Tcw
        self.last_assoc = res.assoc
        self.last_inlier = res.inlier

        # sm.Tcr was computed against ref_at_track — record that same id
        # even if a new keyframe is created below / published concurrently
        if not self.localization_only and self._need_new_keyframe(sm):
            self._create_keyframe(fd, res, timestamp)

        self._append_traj(TrajectoryEntry(
            timestamp, sm.Tcr, ref_at_track, False))
        self.last_fd = fd
        self.frame_id += 1
        return Tcw

    def _finish_loc_frame(self, ms2, fd, res, sm, pay, ref_at_track: int,
                          timestamp: float) -> Optional[np.ndarray]:
        """Localization-mode frame epilogue: mbVO bookkeeping + the
        per-frame relocalization attempt while in VO mode (the reference
        computes both the motion-model and relocalization solutions and
        prefers relocalization, Tracking.cc:450-489)."""
        t = self.cfg.tracking
        vo_mode = sm.n_real_mm < 10
        ok = (sm.n_inliers_map >= t.local_map_tracking_threshold
              or (vo_mode and sm.n_inliers_mm > 20))
        if vo_mode and self.loop_closer is not None:
            Tr, assoc_r = self.loop_closer.relocalize(self.ms, fd)
            if Tr is not None:
                self.stats["reloc"] += 1
                self.state = tracking.OK
                self.velocity = None
                self.last_Tcw = Tr.astype(np.float32)
                self.last_assoc = assoc_r
                self.last_inlier = jnp.ones_like(assoc_r >= 0)
                self.last_fd = fd
                self._record_traj(timestamp, Tr)
                self.frame_id += 1
                return Tr
        if not ok:
            self.state = tracking.LOST
            self.velocity = None
            self._record_traj(timestamp, None)
            self.frame_id += 1
            return None
        self.state = tracking.OK
        self._absorb_track(ms2, res)
        Tcw = sm.Tcw
        if self.last_Tcw is not None:
            self.velocity = Tcw @ np.linalg.inv(self.last_Tcw)
        self.last_Tcw = Tcw
        self.last_assoc = res.assoc
        self.last_inlier = res.inlier
        self._append_traj(TrajectoryEntry(
            timestamp, sm.Tcr, ref_at_track, False))
        self.last_fd = fd
        self.frame_id += 1
        return Tcw

    def _initialize_mono(self, fd, timestamp: float) -> bool:
        """MonocularInitialization (Tracking.cc:663): hold a reference
        frame, match, run the H/F initializer, build the 2-KF map, refine
        with an initial bundle adjustment (CreateInitialMapMonocular's
        20-iteration GBA, :784)."""
        if not hasattr(self, "f_mono_match"):
            (self.f_mono_match,
             self.f_mono_build) = tracking.make_mono_init_fns(self.cfg)
            self._mono_key = jax.random.PRNGKey(7)
        n_kp = int(jnp.sum(fd.valid))
        if getattr(self, "_mono_ref", None) is None:
            if n_kp > 100:
                self._mono_ref = (fd, self.frame_id, timestamp)
            return False
        ref, ref_id, ref_ts = self._mono_ref
        if n_kp <= 100:
            self._mono_ref = None   # (:688-693: drop weak reference frame)
            return False
        m, n_matches = self.f_mono_match(ref, fd)
        if int(n_matches) < 100:    # (:698)
            self._mono_ref = None
            return False
        self._mono_key, k = jax.random.split(self._mono_key)
        ms2, ok, T2, assoc_cur, n_pts = self.f_mono_build(
            self.ms, ref, fd, m, k, jnp.int32(ref_id),
            jnp.int32(self.frame_id), jnp.float32(ref_ts),
            jnp.float32(timestamp))
        if not bool(ok):
            return False
        self.ms = ms2
        self.n_kfs = 2
        self.kf_ordinal = 2
        self._free_kf_slots -= {0, 1}
        self.last_Tcw = np.asarray(T2)
        self.last_assoc = assoc_cur
        self.last_inlier = jnp.ones((fd.n,), bool)
        self.ref_kf = 1
        self.state = tracking.OK
        self.last_kf_frame_id = self.frame_id
        self.stats["kf_inserted"] += 2
        self.stats["mp_created"] += int(n_pts)
        # initial refinement (GlobalBundleAdjustemnt(20), Tracking.cc:784)
        if not hasattr(self, "f_local_ba"):
            mfns = local_mapping.make_mapping_fns(self.cfg)
            self.f_local_ba = mfns.local_ba
        self.ms, _ = self.f_local_ba(self.ms, jnp.int32(1))
        self.last_Tcw = np.asarray(self.ms.kf_pose[1])
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.ms, 0)
            self.loop_closer.add_keyframe(self.ms, 1)
        self._record_traj(timestamp, self.last_Tcw)
        self._mono_ref = None
        return True

    def current_pose_covariance(self):
        """6×6 covariance of the last tracked pose, or None."""
        if getattr(self, "last_fd", None) is None or self.last_Tcw is None:
            return None
        return np.asarray(self.f_pose_cov(
            self.ms, self.last_fd, jnp.asarray(self.last_Tcw, jnp.float32),
            self.last_assoc))

    # -------------------------------------------------------------- stages
    def _initialize(self, fd, timestamp: float) -> bool:
        if self.cfg.sensor == MONOCULAR:
            return self._initialize_mono(fd, timestamp)
        # reference requires 500 keypoints (Tracking.cc:611); we gate on
        # usable depth points, which is the binding constraint
        n_valid = int(jnp.sum((fd.depth > 0) & fd.valid))
        if n_valid < 50:
            return False
        Tcw0 = jnp.eye(4, dtype=jnp.float32)
        self.ms, assoc, n_pts = self.f_init(
            self.ms, fd, Tcw0, jnp.int32(self.frame_id),
            jnp.float32(timestamp))
        self.n_kfs = 1
        self.kf_ordinal = 1
        self._free_kf_slots.discard(0)
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.last_assoc = assoc
        self.last_inlier = jnp.ones((fd.n,), bool)
        self.ref_kf = 0
        self.state = tracking.OK
        self.last_kf_frame_id = self.frame_id
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(n_pts)
        self._record_traj(timestamp, self.last_Tcw)
        return True

    def _absorb_track(self, ms2, res) -> None:
        """Adopt the counter-folded map snapshot from the fused track step
        (or apply masks when the fallback path replaced the result).  The
        async engine overrides this to accumulate instead (single-writer
        rule: tracking never publishes map state there)."""
        if ms2 is not None:
            self.ms = ms2
        else:
            self.ms = self.f_apply_counters(self.ms, res.visible_mask,
                                            res.found_mask)

    def _predict_pose(self) -> np.ndarray:
        if self.velocity is not None:
            return (self.velocity @ self.last_Tcw).astype(np.float32)
        return self.last_Tcw.astype(np.float32)

    # -------------------------------------------------- keyframe decision
    def _mapper_idle(self) -> bool:
        """LocalMapping::AcceptKeyFrames — synchronous mapping is always
        idle between frames; the async engine overrides."""
        return True

    def _mapping_queue_len(self) -> int:
        return 0

    def _interrupt_ba(self) -> None:
        """LocalMapping::InterruptBA (Tracking.cc:1146) — no-op when
        mapping is synchronous."""

    def _need_new_keyframe(self, sm, ref_override: Optional[int] = None
                           ) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1076-1160), reference-fidelity:
        c1b requires the mapper to actually be idle, and when it is busy
        the decision interrupts the running BA and only queues for
        non-monocular sensors with fewer than 3 waiting keyframes.  All
        inputs come pre-fetched in the frame summary.

        ``ref_override``: the windowed engine replays decisions from
        summaries computed BEFORE an in-window keyframe insert; after one,
        the inserting frame's inlier count stands in for the new reference
        keyframe's tracked count (the stale ref_tracked would otherwise
        cascade an insert per frame)."""
        t = self.cfg.tracking
        if not self._free_kf_slots and not self._evict_for_capacity():
            if not self._capacity_warned:
                warnings.warn(
                    "keyframe capacity exhausted "
                    f"(max_keyframes={self.cfg.capacity.max_keyframes}) "
                    "and no keyframe is evictable; consider a larger "
                    "capacity for this sequence", RuntimeWarning)
                self._capacity_warned = True
            return False
        max_frames = int(self.cfg.camera.fps)
        frames_since = self.frame_id - self.last_kf_frame_id
        n_inliers = sm.n_inliers_map
        ref_matches = max(
            sm.ref_tracked3 if self.kf_ordinal > 2 else sm.ref_tracked2, 1)
        if ref_override is not None:
            ref_matches = max(ref_override, 1)
        # stereo close-point pressure (Tracking.cc:1106-1124)
        need_close = (sm.n_tracked_close < 100
                      and sm.n_nontracked_close > 70)
        th_ref_ratio = 0.75 if self.cfg.sensor != MONOCULAR else 0.9
        if self.kf_ordinal < 2:
            th_ref_ratio = 0.4
        idle = self._mapper_idle()
        c1a = frames_since >= max_frames
        c1b = frames_since >= t.min_frames and idle
        c1c = (self.cfg.sensor != MONOCULAR
               and (n_inliers < ref_matches * 0.25 or need_close))
        c2 = ((n_inliers < ref_matches * th_ref_ratio or need_close)
              and n_inliers > 15)
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        self._interrupt_ba()
        return (self.cfg.sensor != MONOCULAR
                and self._mapping_queue_len() < 3)

    # ---------------------------------------------------- keyframe insert
    def _evict_for_capacity(self) -> bool:
        """At keyframe-capacity exhaustion, free one slot by evicting the
        most redundant live keyframe (local_mapping.evict_keyframe_body —
        the bounded-map policy).  Returns True when a slot was freed."""
        if not hasattr(self, "_f_evict"):
            from orbslam2_tpu.runtime import local_mapping as lm_mod
            self._f_evict = lm_mod.make_mapping_fns(
                self.cfg).evict_keyframe
        ms2, victim_dev = self._f_evict(
            self.ms, jnp.int32(self.ref_kf), jnp.int32(self.frame_id))
        victim = int(victim_dev)
        if victim < 0:
            return False
        self.ms = ms2
        self._on_kfs_culled(ms2, [victim])   # rebases traj + frees slot
        self.stats["kf_evicted"] = self.stats.get("kf_evicted", 0) + 1
        return True

    def _take_kf_slot(self) -> int:
        slot = min(self._free_kf_slots)
        self._free_kf_slots.discard(slot)
        # the slot's old identity is gone — entries referencing it were
        # rebased at cull time or at append time via _culled_remap
        self._culled_remap.pop(slot, None)
        return slot

    def _append_traj(self, e: TrajectoryEntry) -> None:
        """Append a trajectory entry, rebasing through any culled
        reference keyframes first (covers entries whose reference was
        culled between track time and append time)."""
        with self._traj_lock:
            seen = set()
            while not e.lost and e.ref_kf in self._culled_remap \
                    and e.ref_kf not in seen:
                seen.add(e.ref_kf)
                p, Tcp = self._culled_remap[e.ref_kf]
                e.Tcr = e.Tcr @ Tcp
                e.ref_kf = p
            self.trajectory.append(e)

    def _counter_args(self):
        """(visible, found) int32 [P] accumulators folded at insertion.
        Synchronous tracking already folds per frame → zeros here; the
        async engine returns (and resets) its accumulated masks."""
        return self._zeros_p, self._zeros_p

    def _run_mapping_step(self, ms, fd, Tcw, assoc, kf_slot: int,
                          parent: int, frame_id: int, timestamp: float,
                          ba_ok: bool, counters=None):
        vis, found = counters if counters is not None \
            else self._counter_args()
        do_ba = bool(ba_ok and self.kf_ordinal >= 3)
        do_cull = bool(self.kf_ordinal >= 5)
        ms, stats_dev = self.f_mapping_step(
            ms, fd, Tcw, assoc, jnp.int32(kf_slot),
            jnp.int32(self.kf_ordinal), jnp.int32(parent),
            jnp.int32(frame_id), jnp.float32(timestamp),
            jnp.bool_(do_ba), jnp.bool_(do_cull), vis, found)
        stats = np.asarray(stats_dev)      # the ONE host fetch
        self.kf_ordinal += 1
        self.n_kfs += 1
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(stats[0]) + int(stats[2])
        self.stats["mp_culled"] += int(stats[1])
        self.stats["mp_fused"] += int(stats[3])
        self.stats["ba_outliers"] += int(stats[4])
        self.stats["kf_culled"] += int(stats[5])
        self.n_live_points = int(stats[6])
        victims = [int(v) for v in stats[7:] if v >= 0]
        if victims:
            self._on_kfs_culled(ms, victims)
        return ms

    def _on_kfs_culled(self, ms, victims: List[int]) -> None:
        """Rebase trajectory entries off culled reference keyframes onto
        their spanning-tree parents (the reference's mTcp walk,
        System.cc:478-503 / KeyFrame.cc:533), then free the slots for
        reuse."""
        pose = np.asarray(ms.kf_pose)          # small: [K, 4, 4]
        parent = np.asarray(ms.kf_parent)
        self.n_kfs -= len(victims)
        vic = set(victims)
        remap = {}
        for v in victims:
            p = int(parent[v])
            # chain through parents culled in the same batch
            seen = {v}
            while p in vic and p not in seen and p >= 0:
                seen.add(p)
                p = int(parent[p])
            p = max(p, 0)
            remap[v] = (p, (pose[v] @ np.linalg.inv(pose[p])).astype(
                np.float32))
        with self._traj_lock:
            self._culled_remap.update(remap)
            for e in self.trajectory:
                if not e.lost and e.ref_kf in remap:
                    p, Tcp = remap[e.ref_kf]
                    e.Tcr = e.Tcr @ Tcp
                    e.ref_kf = p
        if self.ref_kf in remap:
            self.ref_kf = remap[self.ref_kf][0]
        if self.loop_closer is not None:
            for v in victims:
                self.loop_closer.db = self.loop_closer.db.erase(jnp.int32(v))
        self._free_kf_slots |= vic

    def _create_keyframe(self, fd, res, timestamp: float) -> None:
        kf_slot = self._take_kf_slot()
        self.ms = self._run_mapping_step(
            self.ms, fd, res.Tcw, res.assoc, kf_slot, self.ref_kf,
            self.frame_id, timestamp, ba_ok=True)
        self.ref_kf = kf_slot
        self.last_kf_frame_id = self.frame_id
        # refresh tracking association so new points participate
        # immediately (associations may also have been fused away)
        self.last_assoc = self.ms.kf_mp[kf_slot]
        self.last_inlier = jnp.ones_like(self.last_inlier)

        # ---- loop closing (LoopClosing::Run per keyframe) ----
        if self.loop_closer is not None:
            self.ms, closed = self.loop_closer.on_keyframe(
                self.ms, kf_slot, self.kf_ordinal)
            # a background GBA may have finished since the last keyframe —
            # propagate its corrections now (map-owner context,
            # LoopClosing.cc:715-775)
            self.ms, merged = self.loop_closer.gba.poll_and_merge(self.ms)
            if closed or merged:
                self.stats["loops_closed"] += int(closed)
                # poses moved wholesale — rebase the motion model
                self.velocity = None
                self.last_Tcw = np.asarray(self.ms.kf_pose[kf_slot])

    def _auto_reset(self) -> None:
        """Tracking::Reset semantics (Tracking.cc:1605-1654) in place:
        clear map, keyframe DB, loop-closing state and trajectory; keep
        the compiled programs.  Triggered by the lost-≤5-KF guard."""
        cfg = self.cfg
        self.ms = M.empty_map(cfg)
        self.state = tracking.NO_IMAGES_YET
        self.n_kfs = 0
        self.kf_ordinal = 0
        self.n_live_points = 0
        self.last_kf_frame_id = self.frame_id
        self.ref_kf = 0
        self.velocity = None
        self.last_Tcw = None
        self.last_assoc = None
        self.last_inlier = None
        self.last_fd = None
        self._mono_ref = None
        self._free_kf_slots = set(range(cfg.capacity.max_keyframes))
        with self._traj_lock:
            self._culled_remap = {}
            self.trajectory = []        # mlRelativeFramePoses.clear()
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.gba.abort()
            lc.reset_db()
            lc.consistent_groups = []
            lc.prev_loops = []
            lc.last_loop_kf = -1
            lc._deferred = None
        self.stats["resets"] = self.stats.get("resets", 0) + 1

    def _handle_lost(self, fd, timestamp: float) -> Optional[np.ndarray]:
        """Relocalization path (Tracking.cc:434-449)."""
        if self.loop_closer is None:
            self._record_traj(timestamp, None)
            self.frame_id += 1
            return None
        Tcw, assoc = self.loop_closer.relocalize(self.ms, fd)
        self.frame_id += 1
        if Tcw is None:
            self._record_traj(timestamp, None)
            return None
        self.stats["reloc"] += 1
        self.state = tracking.OK
        self.velocity = None
        self.last_Tcw = Tcw.astype(np.float32)
        self.last_assoc = assoc
        self.last_inlier = jnp.ones_like(assoc >= 0)
        self.last_fd = fd
        self._record_traj(timestamp, Tcw)
        return Tcw

    def _record_traj(self, timestamp: float, Tcw: Optional[np.ndarray]):
        if Tcw is None:
            self._append_traj(TrajectoryEntry(
                timestamp, np.eye(4, dtype=np.float32), self.ref_kf, True))
            return
        Tref = np.asarray(self.ms.kf_pose[self.ref_kf])
        Tcr = Tcw @ np.linalg.inv(Tref)
        self._append_traj(TrajectoryEntry(
            timestamp, Tcr.astype(np.float32), self.ref_kf, False))

    def finish_gba(self) -> bool:
        """Wait for a background global BA and merge its result (the
        replayer/shutdown handshake, System.cc:169-183, 435-439)."""
        if self.loop_closer is None:
            return False
        self.loop_closer.gba.wait()
        self.ms, merged = self.loop_closer.gba.poll_and_merge(self.ms)
        if merged:
            self.velocity = None
        return merged

    # ------------------------------------------------------------- outputs
    def frame_poses(self) -> List[Optional[np.ndarray]]:
        """Reconstruct per-frame camera poses Tcw through the (possibly
        BA-corrected) reference keyframes (System::SaveTrajectoryTUM,
        System.cc:478-503)."""
        kf_pose = np.asarray(self.ms.kf_pose)
        out = []
        for e in self.trajectory:
            if e.lost:
                out.append(None)
            else:
                out.append(e.Tcr @ kf_pose[e.ref_kf])
        return out

    def map_points(self) -> np.ndarray:
        """Live map-point cloud (System::GetMap, System.cc:793)."""
        pos = np.asarray(self.ms.mp_pos)
        valid = np.asarray(self.ms.mp_valid)
        return pos[valid]
