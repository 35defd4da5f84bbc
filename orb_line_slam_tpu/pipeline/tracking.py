"""Per-frame tracking state machine + inline local mapping.

Static-shape JAX rebuild of src/Tracking.cc and src/LocalMapping.cc
(SURVEY.md §2.1 rows 2-3, §3.2-3.3).  The reference's
Tracking/LocalMapping pthreads become two device programs driven from
one host loop: a per-frame fused ``track_step`` and a per-keyframe map
step (landmark creation, culling, local BA).  All device work is
static-shape jitted; the host does bookkeeping only.

Pipelined execution: every blocking host↔device round-trip stalls the
frame loop, so the steady-state loop NEVER uploads per-frame state and fetches ONE ~100 B
packed vector per frame:

- pose, velocity, association and found/visible statistics are device
  carries — each ``track_step`` output feeds the next dispatch
  directly (zero uploads per frame);
- with ``pipeline_depth=1`` the host consumes frame k-1's packed
  output while frame k's device program runs, hiding the fetch
  latency entirely (the reference hides mapping latency behind its
  LocalMapping pthread the same way — SURVEY.md §2.4);
- keyframe events fetch one packed buffer (pack_kf_event) and refresh
  the device map mirror with one packed delta upload (pipeline/
  mirror.py) instead of ~15 array transfers.

State machine: NOT_INITIALIZED → OK ↔ LOST, as the reference
(relocalization against keyframe descriptors brings LOST back to OK).
Interventions that rewrite host pose state (relocalization, loop
corrections) drain the pipeline and re-dispatch queued frames
synchronously — rare by construction.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..backend.pose_opt import pose_optimize
from ..backend.local_ba import bundle_adjust
from ..config import SlamConfig
from ..frontend.frame import Frame, build_stereo_frame
from ..geometry.host import (
    nbackproject,
    nse3_apply,
    nse3_compose,
    nse3_inverse,
    nse3_relative,
)
from ..matching.point_matcher import match_descriptors, rotation_consistency
from ..slam_map.map_store import MapStore
from ..utils.timing import StageTimer
from .track_step import (
    MapMirror,
    override_carry,
    pack_kf_event,
    track_step,
    zero_stats,
)


@dataclasses.dataclass
class TrajectoryEntry:
    frame_id: int
    timestamp: float
    ref_kf: int
    R_rel: np.ndarray  # T_cam<-refKF
    t_rel: np.ndarray
    lost: bool


@jax.jit
def _flatten_result(res):
    """Pack any result pytree into ONE float32 buffer so the host pays
    a single round-trip to fetch it (bool leaves ride as 0/1)."""
    leaves = jax.tree_util.tree_leaves(res)
    return jnp.concatenate([jnp.asarray(l, jnp.float32).ravel() for l in leaves])


def _pack_for_fetch(res):
    leaves, treedef = jax.tree_util.tree_flatten(res)
    shapes = [(tuple(l.shape), np.dtype(l.dtype)) for l in leaves]
    return _flatten_result(res), treedef, shapes


def _unpack_fetched(buf, treedef, shapes):
    out = []
    o = 0
    for shape, dt in shapes:
        n = int(np.prod(shape)) if shape else 1
        v = buf[o:o + n].reshape(shape)
        o += n
        if dt == np.bool_:
            v = v > 0.5
        elif np.issubdtype(dt, np.integer):
            v = np.round(v).astype(dt)
        out.append(v)
    return jax.tree_util.tree_unflatten(treedef, out)


@dataclasses.dataclass
class _PipeEntry:
    """One in-flight frame: dispatched, not yet host-consumed."""

    fid: int
    ts: float
    frame: Frame                  # device pytree
    prev_frame: Frame             # device pytree of the prior frame
    lines: object                 # LineFeatures or None
    out: object                   # TrackOut (device)
    snap_host: np.ndarray         # snapshot global ids at dispatch time
    ln_ids: Optional[np.ndarray]  # mirror line ids at dispatch time
    kf_epoch: int = 0             # keyframe epoch at dispatch time
    # pack_kf_event output, dispatched speculatively WITH the frame and
    # async-copied: if this frame becomes a keyframe the ~180 KB event
    # buffer is already on host (no blocking fetch per keyframe); if
    # not, it cost ~1 ms of device time and an idle-link transfer.
    kf_packed: object = None


class Tracker:
    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        n_lines = cfg.lines.n_lines if cfg.lines.enabled else 0
        self.map = MapStore(cfg.map, cfg.orb.n_features, n_lines=n_lines)
        self.cur_lines = None   # LineFeatures of the current frame
        self.cur_ln_assoc = None
        self.state = "NOT_INITIALIZED"
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        self.vel: Optional[tuple[np.ndarray, np.ndarray]] = None  # T_k<-k-1
        self.last_frame: Optional[Frame] = None
        self.last_assoc: Optional[np.ndarray] = None
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, np.float32)
        self.ref_kf = -1
        self.frame_id = -1
        self.frames_since_kf = 0
        self.ref_kf_matches = 0
        self.recent_lm: list[np.ndarray] = []
        self.recent_ln: list[np.ndarray] = []
        self.trajectory: list[TrajectoryEntry] = []
        self.stats: list[dict] = []
        self.on_keyframe = None          # callback(kf_id) after insertion
        self.localization_only = False   # tracking-only mode
        self.reloc_candidates_fn = None  # BoW relocalization candidates
        # Defer local-BA write-back (applied by a non-blocking poll when
        # the device solve lands): tracking never blocks on mapping (the
        # reference's LocalMapping-pthread property, SURVEY §7.2 #4).
        self.async_mapping = True
        # 0 = consume each frame's result immediately (exact, simple);
        # 1 = lag one frame so the packed fetch overlaps the next
        # frame's device compute (steady-state throughput mode).
        self.pipeline_depth = 0
        # Trajectory entries indexed by reference KF, so culling a KF
        # re-anchors its entries to the spanning-tree parent in O(own).
        self._traj_by_kf: dict[int, list[TrajectoryEntry]] = {}
        self.map.on_kf_culled.append(self._on_kf_culled)
        self._pending_ba = None
        self.is_mono = False
        self.cur_frame = None
        self._fh_key = None              # lazy host frame mirror
        self.cur_fh = None
        # Device-side map mirror: refreshed per map MUTATION (keyframe
        # events), incrementally — see _refresh_mirror.
        self._mir = None
        self._mirror_dirty = True
        self._ref_frame_dev = None       # device Frame of the ref KF
        self._ref_frame_kf = -1
        # Pipeline state.
        self._q: list[_PipeEntry] = []
        self._carry = None               # (frame, TrackOut) device carries
        # Keyframe epoch: a frame DISPATCHED before the latest keyframe
        # existed cannot see its landmarks — judging it against the new
        # keyframe's inlier bar cascades into a KF-per-frame storm at
        # pipeline_depth > 0, so such frames never trigger keyframes.
        self._kf_epoch = 0
        # Mapping-job pipeline (the LocalMapping lag): per-KF device
        # programs (triangulation + fuse) dispatched at keyframe events,
        # applied by a non-blocking poll when they complete; local BA is
        # dispatched right after their application.  A QUEUE: keyframe
        # creation never blocks on the previous keyframe's chain
        # (generation guards in the apply paths make late application
        # safe); backpressure joins the queue only when 2+ chains pile
        # up.
        self._map_jobs: list[tuple] = []  # [(kf, tri_job, fuse_job, t)]
        self._kf_frames: dict[int, Frame] = {}   # device per-KF frames
        self._kf_frames_max = 32
        # Per-stage host timing (tools/profile_stages.py, bench extra).
        self.timing = StageTimer()

    # ------------------------------------------------------------------
    # public per-frame entry points
    # ------------------------------------------------------------------
    def process_stereo(self, img_left, img_right, timestamp: float = 0.0):
        """Track one rectified stereo pair; returns 4x4 Tcw (world->cam)
        of the most recently *consumed* frame (the current frame when
        pipeline_depth=0)."""
        self.frame_id += 1
        l = jnp.asarray(img_left)
        r = jnp.asarray(img_right)
        if self.state != "NOT_INITIALIZED":
            # Steady state: ONE fused device program for the whole frame.
            self.poll_map_jobs()
            self.poll_pending_ba()
            with self.timing.stage("track_dispatch"):
                frame, lf, out = self._dispatch_fused(l, r)
                try:
                    out.packed.copy_to_host_async()
                except AttributeError:
                    pass
            self.cur_frame = frame
            self.cur_lines = lf
            kf_packed = pack_kf_event(frame, out, lines=lf)
            try:
                kf_packed.copy_to_host_async()
            except AttributeError:
                pass
            self._q.append(_PipeEntry(
                fid=self.frame_id, ts=timestamp, frame=frame,
                prev_frame=self._prev_for_dispatch, lines=lf,
                out=out, snap_host=self._mir["snap_host"],
                ln_ids=self._mir["ln_ids"], kf_epoch=self._kf_epoch,
                kf_packed=kf_packed,
            ))
            while len(self._q) > self.pipeline_depth:
                self._consume()
            return self.current_pose()
        with self.timing.stage("frontend_dispatch"):
            frame = build_stereo_frame(l, r, self.cfg)
        if self.cfg.lines.enabled:
            from ..frontend.line_extractor import build_line_features

            self.cur_lines = build_line_features(l, r, self.cfg.camera, self.cfg.lines)
        return self._track(frame, timestamp)

    def process_frame(self, frame: Frame, timestamp: float = 0.0):
        self.frame_id += 1
        return self._track(frame, timestamp)

    def process_mono(self, img, timestamp: float = 0.0):
        """Track a monocular frame (TrackMonocular analog); the map is
        bootstrapped with the two-view initializer (scale-free)."""
        from ..frontend.frame import build_mono_frame

        self.frame_id += 1
        self.is_mono = True
        frame = build_mono_frame(jnp.asarray(img), self.cfg)
        if self.state == "NOT_INITIALIZED":
            self.cur_frame = frame
            self._fh(frame)
            self._try_mono_initialize(frame, timestamp)
            self._record(self.frame_id, timestamp, lost=(self.state != "OK"))
            return self.current_pose()
        return self._track(frame, timestamp)

    def flush(self):
        """Drain the pipeline: consume every in-flight frame and join
        the mapping-job / local-BA chains."""
        while self._q:
            self._consume()
        self.poll_map_jobs(force=True)
        self.flush_pending_ba()
        # A chain application may have enqueued a fresh local BA.
        self.poll_map_jobs(force=True)
        self.flush_pending_ba()

    # ------------------------------------------------------------------
    def _try_mono_initialize(self, frame: Frame, timestamp):
        from ..frontend.initializer import initialize_two_view

        if getattr(self, "_init_ref", None) is None:
            if int(self.cur_fh.valid.sum()) >= 100:
                self._init_ref = (frame, self.cur_fh, timestamp, self.frame_id)
            return
        ref, refh, ref_ts, ref_id = self._init_ref
        fh = self.cur_fh
        from ..matching.point_matcher import match_in_window

        m = match_in_window(ref, frame, radius=100.0, max_dist=50, ratio=0.9)
        mask, idx = jax.device_get((m.mask, m.idx))
        # Minimum match support scales with the feature budget (the
        # reference's 100 assumes 2000+ features); below it, slide the
        # reference frame forward.
        min_matches = max(70, self.cfg.orb.n_features // 25)
        if mask.sum() < min_matches:
            self._init_ref = (frame, fh, timestamp, self.frame_id)  # reset ref
            return
        p1 = refh.xy
        p2 = fh.xy[np.where(idx >= 0, idx, 0)]
        res = initialize_two_view(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
            jax.random.PRNGKey(self.frame_id), self.cfg.camera,
        )
        success, inl, pts, R2, t2 = jax.device_get(
            (res.success, res.inliers, res.points3d, res.R, res.t)
        )
        if not bool(success):
            return
        # Normalize scale: median depth -> 1 (the reference's
        # CreateInitialMapMonocular inverse-median-depth scaling).
        med = np.median(pts[inl, 2])
        if med <= 0:
            return
        pts = pts / med
        t2 = t2 / med

        kf0 = self.map.add_keyframe(
            refh, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            ref_id, ref_ts,
        )
        kf1 = self.map.add_keyframe(fh, R2, t2, self.frame_id, timestamp,
                                    parent=kf0)
        rows = np.nonzero(inl)[0]
        ids = self.map.add_points(
            pts[rows], refh.desc[rows], refh.octave[rows], kf0, rows,
        )
        self.map.kf_obs_lm[kf1, idx[rows[: len(ids)]]] = ids
        self.map.touch_obs()
        self.map.update_point_stats(ids)
        self.recent_lm.append(ids)

        self.R, self.t = R2.astype(np.float32), t2.astype(np.float32)
        self.ref_kf = kf1
        self.ref_kf_matches = max(len(ids), 40)
        self.state = "OK"
        self.last_frame = frame
        self.last_fh = fh
        assoc = np.full(frame.n, -1, np.int32)
        assoc[idx[rows[: len(ids)]]] = ids
        self.last_assoc = assoc
        self.last_R = self.R.copy()
        self.last_t = self.t.copy()
        self.vel = None
        self.frames_since_kf = 0
        self._local_ba(kf1)
        self.poll_pending_ba()
        if self.on_keyframe is not None:
            self.on_keyframe(kf0)
            self.on_keyframe(kf1)
        self._ref_frame_dev = frame
        self._ref_frame_kf = kf1
        self._kf_frames[kf0] = ref
        self._kf_frames[kf1] = frame
        self._carry = None
        self.mark_map_dirty()

    # ------------------------------------------------------------------
    def _fh(self, frame: Frame):
        """Lazy host mirror of a frame (ONE batched fetch, only on paths
        that need host-side feature data: map init, relocalization)."""
        if self._fh_key is not frame:
            self.cur_fh = jax.device_get(frame)
            self._fh_key = frame
        return self.cur_fh

    # ------------------------------------------------------------------
    # steady-state: dispatch + consume
    # ------------------------------------------------------------------
    def _track(self, frame: Frame, timestamp: float):
        self.cur_frame = frame
        # Non-blocking polls: apply finished mapping jobs (triangulation
        # + fuse, then dispatch local BA) and a finished local BA.
        self.poll_map_jobs()
        self.poll_pending_ba()

        if self.state == "NOT_INITIALIZED":
            fh = self._fh(frame)
            if int((fh.depth > 0).sum()) >= 100:
                self._stereo_initialize(frame, timestamp)
            self._record(self.frame_id, timestamp, lost=(self.state != "OK"))
            return self.current_pose()

        with self.timing.stage("track_dispatch"):
            out = self._dispatch_track_step(frame, self.cur_lines)
            try:
                out.packed.copy_to_host_async()
            except AttributeError:
                pass
        self._q.append(_PipeEntry(
            fid=self.frame_id, ts=timestamp, frame=frame,
            prev_frame=self._prev_for_dispatch, lines=self.cur_lines,
            out=out, snap_host=self._mir["snap_host"],
            ln_ids=self._mir["ln_ids"], kf_epoch=self._kf_epoch,
        ))
        while len(self._q) > self.pipeline_depth:
            self._consume()
        return self.current_pose()

    def _dispatch_inputs(self, lines):
        """Mirror refresh + carry/cold-start inputs shared by the
        separate and fused dispatch paths.  Returns (mir, has_lines,
        last_frame, args) with args = everything between last_gid and
        ln_vis in track_step's signature."""
        if (
            self._mirror_dirty
            or self._mir is None
            or self._mir["ref_kf"] != self.ref_kf
        ):
            self._refresh_mirror(lines)
        mir = self._mir
        Lcap = mir["ln_valid"].shape[0]
        if self._carry is not None:
            last_frame, prev = self._carry
            last_gid = prev.assoc_gid
            Rv, tv, hv = prev.Rv, prev.tv, prev.ok
            R_last, t_last = prev.R, prev.t
            found, vis = prev.found_acc, prev.vis_acc
            ln_found, ln_vis = prev.ln_found_acc, prev.ln_vis_acc
            if ln_found.shape[0] != Lcap:  # line capacity switched
                ln_found = jnp.zeros(Lcap, jnp.int32)
                ln_vis = jnp.zeros(Lcap, jnp.int32)
        else:
            # Cold start after init / intervention: host uploads; path A
            # is disabled for one frame (no velocity), so the stale
            # association vector is never read.
            last_frame = self.last_frame
            last_gid = jnp.full((self.cfg.orb.n_features,), -1, jnp.int32)
            Rv = jnp.eye(3, dtype=jnp.float32)
            tv = jnp.zeros(3, jnp.float32)
            hv = jnp.asarray(False)
            R_last = jnp.asarray(self.last_R)
            t_last = jnp.asarray(self.last_t)
            cap = mir["snap_ids"].shape[0]
            found = jnp.zeros(cap, jnp.int32)
            vis = jnp.zeros(cap, jnp.int32)
            ln_found = jnp.zeros(Lcap, jnp.int32)
            ln_vis = jnp.zeros(Lcap, jnp.int32)
        args = (
            last_gid, Rv, tv, R_last, t_last, hv,
            mir["ref_xy"], mir["ref_desc"], mir["ref_angle"], mir["ref_slots"],
            mir["snap_ids"], found, vis, ln_found, ln_vis,
        )
        return mir, last_frame, args

    def _dispatch_track_step(self, frame: Frame, lines):
        """Dispatch the fused track step (device carries, no fetch)."""
        mir, last_frame, args = self._dispatch_inputs(lines)
        has_lines = mir["has_lines"] and lines is not None
        out = track_step(
            frame, last_frame, mir["pt"], *args,
            lines if has_lines else None,
            mir["ln_start"], mir["ln_end"], mir["ln_desc"], mir["ln_valid"],
            cfg=self.cfg, has_lines=has_lines,
        )
        self._prev_for_dispatch = last_frame
        self._carry = (frame, out)
        return out

    def _dispatch_fused(self, img_l, img_r):
        """Steady-state stereo path: front-end (points + lines) and the
        track step in ONE device program (track_step.
        fused_frame_track_step) — three separate dispatches leave
        scheduling gaps between programs.
        Returns (frame, line_features_or_None, TrackOut)."""
        from .track_step import fused_frame_track_step

        mir, last_frame, args = self._dispatch_inputs(self.cur_lines)
        has_lines = bool(mir["has_lines"]) and self.cfg.lines.enabled
        frame, lf, out = fused_frame_track_step(
            img_l, img_r, last_frame, mir["pt"], *args,
            mir["ln_start"], mir["ln_end"], mir["ln_desc"], mir["ln_valid"],
            cfg=self.cfg, has_lines=has_lines,
        )
        self._prev_for_dispatch = last_frame
        self._carry = (frame, out)
        return frame, lf, out

    def _redispatch(self, se: _PipeEntry):
        """Re-run the fused step for a queued frame against fresh host
        state (after an intervention)."""
        self._carry = None
        self.last_frame = se.prev_frame
        se.out = self._dispatch_track_step(se.frame, se.lines)
        se.snap_host = self._mir["snap_host"]
        se.ln_ids = self._mir["ln_ids"]
        se.kf_packed = None  # stale: re-pack lazily at the KF event
        return np.asarray(se.out.packed)

    def _consume(self):
        e = self._q.pop(0)
        with self.timing.stage("consume_fetch"):
            packed = np.asarray(e.out.packed)
        ok = packed[12] > 0.5

        if not ok:
            # Reference ladder's last rung: relocalization (BoW/PnP).
            r_ok, _, _ = self._relocalize(e.frame)
            if r_ok:
                self.last_R = self.R.copy()
                self.last_t = self.t.copy()
                self.vel = None
                packed = self._redispatch(e)
                ok = packed[12] > 0.5
                self._drain_required = True

        self._process_entry(e, packed, ok)
        if getattr(self, "_drain_required", False):
            self._drain_required = False
            self._drain_stale()

    def _drain_stale(self):
        """An intervention rewrote host pose state: every later queued
        frame was dispatched against stale carries — re-dispatch each
        synchronously in order."""
        stale = self._q
        self._q = []
        for se in stale:
            packed = self._redispatch(se)
            ok = packed[12] > 0.5
            if not ok:
                r_ok, _, _ = self._relocalize(se.frame)
                if r_ok:
                    packed = self._redispatch(se)
                    ok = packed[12] > 0.5
            self._process_entry(se, packed, ok)

    def _process_entry(self, e: _PipeEntry, packed, ok: bool):
        n_inliers = int(packed[13])
        tracked_close = int(packed[17])
        untracked_close = int(packed[18])

        if ok:
            self.R = packed[0:9].reshape(3, 3).astype(np.float32)
            self.t = packed[9:12].astype(np.float32)
            self.state = "OK"
            # velocity = T_curr * T_last^-1 (host mirror of the carry)
            self.vel = nse3_relative(self.R, self.t, self.last_R, self.last_t)
            if e.kf_epoch == self._kf_epoch and self._need_keyframe(
                n_inliers, tracked_close, untracked_close
            ):
                self._create_keyframe(e, n_inliers)
                self.frames_since_kf = 0
            else:
                self.frames_since_kf += 1
        else:
            self.state = "LOST"
            self.vel = None

        self.last_frame = e.frame
        self.last_R = self.R.copy()
        self.last_t = self.t.copy()
        self.stats.append(
            {
                "frame": e.fid,
                "inliers": n_inliers,
                "state": self.state,
                "motion_model": packed[14] > 0.5,
                "tracked_close": tracked_close,
                "untracked_close": untracked_close,
                "is_kf": self.frames_since_kf == 0,
            }
        )
        self._record(e.fid, e.ts, lost=not ok)

    # ------------------------------------------------------------------
    def mark_map_dirty(self):
        """The host map mutated: refresh the device mirror before the
        next track dispatch.  Called at keyframe-rate events only."""
        self._mirror_dirty = True

    def _refresh_mirror(self, lines=None):
        """(Re)sync the device-side map mirror.  The point table is
        updated INCREMENTALLY: one packed uint32 delta upload covering
        only host-dirty rows (pipeline/mirror.py); ref-KF feature tables
        reuse the keyframe's device Frame when available; ref slots +
        local-map snapshot ids ride one small int32 upload."""
        from .mirror import (
            mirror_apply,
            mirror_apply_pos,
            mirror_from_flat,
            pack_delta,
            pack_delta_pos,
            pack_full,
        )

        _t0 = time.perf_counter()
        m = self.map
        cfg = self.cfg
        k = self.ref_kf
        # Local-map snapshot ids (covisible neighbourhood of the ref KF).
        cap = cfg.map.local_points
        ids, _ = m.covisible_keyframes(k, min_weight=1, max_n=20)
        local_kfs = [k] + [int(i) for i in ids]
        obs = m.kf_obs_lm[local_kfs]
        lm = np.unique(obs[obs >= 0])
        lm = lm[m.pt_valid[lm]]
        if len(lm) > cap:
            # Keep the newest landmarks: older ids fall out of the local
            # window first (they are covered by their own keyframes).
            lm = lm[-cap:]
        snap_ids = np.full(cap, -1, np.int32)
        snap_ids[: len(lm)] = lm

        # --- point table: packed delta or full upload ---
        # (local BA dirties up to local_points=8192 rows per apply; the
        # delta path stays ~6x cheaper than a full table upload until
        # a third of the table changed)
        all_dirty, dirty, dirty_pos = m.pop_dirty_pts()
        if self._mir is None or all_dirty or len(dirty) > m.P // 3:
            pt = mirror_from_flat(jnp.asarray(pack_full(m)))
        else:
            pt = self._mir["pt"]
            if len(dirty):
                pt = mirror_apply(pt, jnp.asarray(pack_delta(m, dirty)))
            if len(dirty_pos):
                pt = mirror_apply_pos(
                    pt, jnp.asarray(pack_delta_pos(m, dirty_pos))
                )

        if self._ref_frame_dev is not None and self._ref_frame_kf == k:
            fr = self._ref_frame_dev
            ref_xy, ref_desc, ref_angle = fr.xy, fr.desc, fr.angle
        else:
            ref_xy = jnp.asarray(m.kf_xy[k])
            ref_desc = jnp.asarray(m.kf_desc[k])
            ref_angle = jnp.asarray(m.kf_angle[k])

        # --- lines ---
        lf = lines if lines is not None else self.cur_lines
        has_lines = (
            cfg.lines.enabled and lf is not None and bool(m.ln_valid.any())
        )
        Lcap = cfg.lines.n_lines if has_lines else 8
        ln_starts = np.zeros((Lcap, 3), np.float32)
        ln_ends = np.ones((Lcap, 3), np.float32)
        ln_descs = np.zeros((Lcap, 32), np.uint8)
        ln_valid = np.zeros(Lcap, bool)
        ln_ids = None
        if has_lines:
            ln_ids = np.nonzero(m.ln_valid)[0][:Lcap]
            nl = len(ln_ids)
            ln_starts[:nl] = m.ln_start[ln_ids]
            ln_ends[:nl] = m.ln_end[ln_ids]
            ln_descs[:nl] = m.ln_desc[ln_ids]
            ln_valid[:nl] = True

        # --- ref slots + snapshot ids + line table: ONE packed upload ---
        from .mirror import unpack_mirror_aux

        F = m.F
        uu = lambda a: np.ascontiguousarray(a).view(np.uint32).ravel()  # noqa: E731
        aux = np.concatenate([
            uu(m.kf_obs_lm[k].astype(np.int32)), uu(snap_ids),
            uu(ln_starts), uu(ln_ends),
            uu(ln_descs), ln_valid.astype(np.uint32),
        ])
        ref_slots, snap_dev, ln_start_d, ln_end_d, ln_desc_d, ln_valid_d = (
            unpack_mirror_aux(jnp.asarray(aux), F, cap, Lcap)
        )

        # The snapshot is changing: re-index the in-flight found/visible
        # accumulator carries (points AND lines) from old slots to new
        # (device-side remap, no fetch) so counts stay attributed to the
        # same landmarks (ADVICE r2 #1).
        if self._carry is not None and self._mir is not None:
            old = self._mir["snap_host"]
            old_ln = self._mir["ln_ids"]
            Lcap_old = self._mir["ln_valid"].shape[0]
            same_pts = len(old) == len(lm) and np.array_equal(old, lm)
            same_lns = (
                Lcap_old == Lcap
                and (old_ln is None) == (ln_ids is None)
                and (
                    old_ln is None
                    or (len(old_ln) == len(ln_ids) and np.array_equal(old_ln, ln_ids))
                )
            )
            if not (same_pts and same_lns) and Lcap_old == Lcap:
                from .track_step import remap_stats

                lookup = np.full(m.P, -1, np.int32)
                lookup[old] = np.arange(len(old), dtype=np.int32)
                remap = np.full(cap, -1, np.int32)
                remap[: len(lm)] = lookup[lm]
                ln_remap = np.full(Lcap, -1, np.int32)
                if ln_ids is not None and old_ln is not None and len(old_ln):
                    llk = np.full(m.L, -1, np.int32)
                    llk[old_ln] = np.arange(len(old_ln), dtype=np.int32)
                    ln_remap[: len(ln_ids)] = llk[ln_ids]
                self._carry = (
                    self._carry[0],
                    remap_stats(
                        self._carry[1], jnp.asarray(remap), jnp.asarray(ln_remap)
                    ),
                )
        self._mir = {
            "pt": pt,
            "ref_xy": ref_xy,
            "ref_desc": ref_desc,
            "ref_angle": ref_angle,
            "ref_slots": ref_slots,
            "snap_ids": snap_dev,
            "snap_host": lm,
            "ln_start": ln_start_d,
            "ln_end": ln_end_d,
            "ln_desc": ln_desc_d,
            "ln_valid": ln_valid_d,
            "ln_ids": ln_ids,
            "has_lines": has_lines,
            "ref_kf": k,
        }
        self._mirror_dirty = False
        self.timing.add("mirror_refresh", time.perf_counter() - _t0)

    # ------------------------------------------------------------------
    def current_pose(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    def _record(self, frame_id, timestamp, lost):
        if self.ref_kf < 0:
            self.trajectory.append(
                TrajectoryEntry(frame_id, timestamp, -1, np.eye(3), np.zeros(3), True)
            )
            return
        # T_c<-r = T_cw * T_rw^-1   (replayed against the *final* KF pose
        # at save time — SURVEY.md §3.5's relative-to-refKF scheme).
        Rr, tr = self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf]
        Rrel, trel = nse3_relative(self.R, self.t, Rr, tr)
        e = TrajectoryEntry(
            frame_id, timestamp, self.ref_kf, Rrel, trel, lost,
        )
        self.trajectory.append(e)
        self._traj_by_kf.setdefault(self.ref_kf, []).append(e)

    def _on_kf_culled(self, k: int, parent: int):
        """A keyframe slot is being recycled: re-anchor every trajectory
        entry referencing it onto the spanning-tree parent (the
        reference replays through parents in SaveTrajectoryTUM when a
        reference KF isBad — SURVEY.md §3.5)."""
        if parent < 0 or not self.map.kf_valid[parent]:
            live = np.nonzero(self.map.kf_valid[: self.map._next_kf])[0]
            if len(live) == 0:
                return
            parent = int(live[np.argmin(np.abs(live - k))])
        Rk, tk = self.map.kf_R[k], self.map.kf_t[k]
        Rp, tp = self.map.kf_R[parent], self.map.kf_t[parent]
        Rkp, tkp = nse3_relative(Rk, tk, Rp, tp)  # T_k<-p
        for e in self._traj_by_kf.pop(k, []):
            e.R_rel, e.t_rel = nse3_compose(e.R_rel, e.t_rel, Rkp, tkp)
            e.ref_kf = parent
            self._traj_by_kf.setdefault(parent, []).append(e)
        self._kf_frames.pop(k, None)
        if self.ref_kf == k:
            self.ref_kf = parent

    def final_trajectory(self):
        """Replay per-frame relative poses against final keyframe poses."""
        self.flush()
        out = []
        for e in self.trajectory:
            if e.ref_kf < 0:
                out.append((e.frame_id, e.timestamp, np.eye(3), np.zeros(3), e.lost))
                continue
            Rr, tr = self.map.kf_R[e.ref_kf], self.map.kf_t[e.ref_kf]
            R, t = nse3_compose(
                np.asarray(e.R_rel, np.float32), np.asarray(e.t_rel, np.float32),
                Rr, tr,
            )
            out.append((e.frame_id, e.timestamp, R, t, e.lost))
        return out

    # ------------------------------------------------------------------
    def _stereo_initialize(self, frame: Frame, timestamp):
        fh = self._fh(frame)
        self.is_mono = False
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        kf = self.map.add_keyframe(fh, self.R, self.t, self.frame_id, timestamp)
        valid = fh.valid & (fh.depth > 0)
        idx = np.nonzero(valid)[0]
        pts_c = nbackproject(self.cfg.camera, fh.xy, fh.depth)
        ids = self.map.add_points(
            pts_c[idx], fh.desc[idx], fh.octave[idx], kf, idx
        )
        self.recent_lm.append(ids)
        # Line landmarks from stereo endpoint depths, as the reference's
        # StereoInitialization creates MapLines alongside MapPoints.
        if self.cfg.lines.enabled and self.cur_lines is not None:
            lf = jax.device_get(self.cur_lines)
            ln_assoc = np.full(lf.n, -1, np.int32)
            self.map.set_kf_lines(kf, lf, ln_assoc)
            new_ln = np.nonzero(lf.valid & (lf.depth0 > 0) & (lf.depth1 > 0))[0]
            if len(new_ln):
                s_c = nbackproject(self.cfg.camera, lf.p0[new_ln], lf.depth0[new_ln])
                e_c = nbackproject(self.cfg.camera, lf.p1[new_ln], lf.depth1[new_ln])
                ln_ids = self.map.add_lines(
                    s_c, e_c, lf.desc[new_ln], kf, new_ln
                )
                self.recent_ln.append(ln_ids)
        self.ref_kf = kf
        self.ref_kf_matches = len(ids)
        self.state = "OK"
        self.last_frame = frame
        self.last_fh = fh
        self.last_assoc = self.map.kf_obs_lm[kf].copy()
        self.last_R = self.R.copy()
        self.last_t = self.t.copy()
        self.vel = None
        self.frames_since_kf = 0
        self._ref_frame_dev = frame
        self._ref_frame_kf = kf
        self._kf_frames[kf] = frame
        self._carry = None
        self.mark_map_dirty()

    # ------------------------------------------------------------------
    def _pose_opt_from_assoc(self, frame, assoc, R0, t0, line_kw=None):
        """Run motion-only BA on the current landmark associations
        (relocalization ladder only — the steady-state path runs inside
        the fused track_step program)."""
        fh = self._fh(frame)
        sel = assoc >= 0
        lm = np.where(sel, assoc, 0)
        pts = self.map.pt_pos[lm]
        obs = np.stack(
            [fh.xy[:, 0], fh.xy[:, 1], fh.u_right], -1
        ).astype(np.float32)
        res = pose_optimize(
            jnp.asarray(R0), jnp.asarray(t0),
            jnp.asarray(pts), jnp.asarray(obs),
            frame.octave, jnp.asarray(sel & fh.valid),
            self.cfg.camera, self.cfg.orb.scale_factor,
            **(line_kw or {}),
        )
        # Single batched fetch (one round-trip).
        R, t, inl, n_inl = jax.device_get(
            (res.R, res.t, res.inliers, res.n_inliers)
        )
        assoc = np.where(inl, assoc, -1)
        return R, t, assoc, int(n_inl)

    def _track_reference_kf(self, frame: Frame):
        if self.ref_kf < 0:
            return False, np.full(frame.n, -1, np.int32), 0
        k = self.ref_kf
        kf_lm = self.map.kf_obs_lm[k]
        has_lm = (kf_lm >= 0) & self.map.pt_valid[np.clip(kf_lm, 0, self.map.P - 1)]
        # Spatial window (the BoW node pruning analog): cuts confusers so
        # the ratio test keeps far more true matches.
        kf_xy = self.map.kf_xy[k]
        fxy = self._fh(frame).xy
        du = fxy[:, 0:1] - kf_xy[None, :, 0]
        dv = fxy[:, 1:2] - kf_xy[None, :, 1]
        window = jnp.asarray((du * du + dv * dv) < 150.0**2)
        m = match_descriptors(
            frame.desc, frame.valid,
            jnp.asarray(self.map.kf_desc[k]), jnp.asarray(has_lm),
            max_dist=50, ratio=0.75, extra_mask=window,
        )
        keep_d = rotation_consistency(
            frame.angle, jnp.asarray(self.map.kf_angle[k])[m.idx], m.mask
        )
        midx, keep = jax.device_get((m.idx, keep_d))
        if keep.sum() < 15:
            return False, np.full(frame.n, -1, np.int32), 0
        assoc = np.full(frame.n, -1, np.int32)
        assoc[keep] = kf_lm[midx[keep]]
        R, t, assoc, n_inl = self._pose_opt_from_assoc(frame, assoc, self.last_R, self.last_t)
        if n_inl < 10:
            return False, assoc, n_inl
        self.R, self.t = R, t
        return True, assoc, n_inl

    def _relocalize(self, frame: Frame):
        """Relocalization: BoW keyframe-database candidates when the
        loop module is wired in, else recent keyframes (Tracking::
        Relocalization's candidate source is KeyFrameDatabase)."""
        cand = None
        if self.reloc_candidates_fn is not None:
            cand = [
                k for k in self.reloc_candidates_fn(frame) if self.map.kf_valid[k]
            ][:5]
        if not cand:
            cand = [
                k for k in range(self.map._next_kf - 1, -1, -1) if self.map.kf_valid[k]
            ][:5]
        # First pass: EPnP RANSAC from descriptor matches against each
        # candidate's landmarks (Tracking::Relocalization's PnPsolver
        # stage) gives a pose hypothesis without any prior.
        from ..backend.pnp import solve_pnp_ransac

        for k in cand:
            kf_lm = self.map.kf_obs_lm[k]
            has_lm = (kf_lm >= 0) & self.map.pt_valid[np.clip(kf_lm, 0, self.map.P - 1)]
            if has_lm.sum() < 30:
                continue
            m = match_descriptors(
                frame.desc, frame.valid,
                jnp.asarray(self.map.kf_desc[k]), jnp.asarray(has_lm),
                max_dist=50, ratio=0.75,
            )
            mask, idx = jax.device_get((m.mask, m.idx))
            if mask.sum() < 15:
                continue
            lm = np.where(mask, kf_lm[np.where(idx >= 0, idx, 0)], 0)
            res = solve_pnp_ransac(
                jnp.asarray(self.map.pt_pos[lm]), frame.xy,
                jnp.asarray(mask), jax.random.PRNGKey(self.frame_id),
                self.cfg.camera, jnp.ones(frame.n),
            )
            R0, t0, pnp_inl, n_pnp = jax.device_get(res[:4])
            if int(n_pnp) < 15:
                continue
            assoc = np.where(mask & pnp_inl, lm, -1).astype(np.int32)
            R, t, assoc, n_inl = self._pose_opt_from_assoc(frame, assoc, R0, t0)
            if n_inl >= 15:
                self.R, self.t = R, t
                self.ref_kf = k
                return True, assoc, n_inl
        for k in cand:
            self.ref_kf = k
            saved_R, saved_t = self.last_R, self.last_t
            self.last_R = self.map.kf_R[k].copy()
            self.last_t = self.map.kf_t[k].copy()
            ok, assoc, n_inl = self._track_reference_kf(frame)
            if ok and n_inl >= self.cfg.tracking.min_inliers_ok:
                return True, assoc, n_inl
            self.last_R, self.last_t = saved_R, saved_t
        return False, np.full(frame.n, -1, np.int32), 0

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int, tracked_close: int,
                       untracked_close: int):
        """Tracking::NeedNewKeyFrame, condition for condition:
        (c1a | c1b | c1c) & c2, with the LocalMapping-idle gate in c1b
        mapped onto the deferred local BA being applied.  ref_kf_matches
        is the triggering frame's inlier count (the analog of
        TrackedMapPoints(≥2): brand-new single-observation stereo points
        are excluded), so the decay ratios compare like with like."""
        cfg = self.cfg.tracking
        if self.localization_only:
            return False
        need_close = tracked_close < 100 and untracked_close > 70
        is_mono = self.is_mono
        # Mono inserts more eagerly (reference: thRefRatio 0.9 mono,
        # 0.75 stereo) since landmarks only come from triangulation.
        ref_ratio = 0.9 if is_mono else 0.75
        # "LocalMapping idle" = no mapping chain outstanding: neither a
        # deferred BA nor unapplied triangulation/fuse jobs (the window
        # right after a KF when jobs haven't landed is NOT idle).
        mapping_idle = self._pending_ba is None and not self._map_jobs
        nref = max(self.ref_kf_matches, 15)
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= max(cfg.min_frames_between_kf, 1) and mapping_idle
        c1c = (not is_mono) and (n_inliers < nref * 0.25 or need_close)
        c2 = (n_inliers < nref * ref_ratio or need_close) and n_inliers > 15
        return (c1a or c1b or c1c) and c2

    def _create_keyframe(self, e: _PipeEntry, n_inliers: int = 0):
        _t0 = time.perf_counter()
        # Mutation window: the loop-detection worker snapshots map state
        # under this lock (ADVICE r3 #1); RLock — nested applies and the
        # loop-correction path re-enter freely.
        with self.map.lock:
            self._create_keyframe_locked(e, n_inliers)
        self.timing.add("kf_event_total", time.perf_counter() - _t0)

    def _create_keyframe_locked(self, e: _PipeEntry, n_inliers: int = 0):
        self._kf_epoch += 1
        cfg = self.cfg
        # ONE packed fetch: frame feature table + association + line
        # matches + found/visible accumulators (track_step.pack_kf_event).
        from .mirror import unpack_kf_event

        Lcap = e.out.ln_match_idx.shape[0]
        cap = e.out.found_acc.shape[0]
        n_lines = e.lines.p0.shape[0] if e.lines is not None else 0
        with self.timing.stage("kf_event_fetch"):
            buf = np.asarray(
                e.kf_packed if e.kf_packed is not None
                else pack_kf_event(e.frame, e.out, lines=e.lines)
            )
        unpacked = unpack_kf_event(buf, e.frame.n, Lcap, cap, n_lines=n_lines)
        fh, assoc, _inl, ln_idx, ln_mask, found, vis, ln_found, ln_vis = (
            unpacked[:9]
        )
        lf_host = unpacked[9] if n_lines else None
        # Landmark statistics (IncreaseFound / IncreaseVisible),
        # accumulated on device since the last keyframe event.
        sh = e.snap_host
        if len(sh):
            self.map.pt_found[sh] += found[: len(sh)]
            self.map.pt_visible[sh] += vis[: len(sh)]
        # Line landmark statistics (MapLine Increase{Found,Visible}) —
        # the found-ratio clause of cull_lines is live from here on.
        if e.ln_ids is not None and len(e.ln_ids):
            nl = min(len(e.ln_ids), len(ln_found))
            self.map.ln_found[e.ln_ids[:nl]] += ln_found[:nl]
            self.map.ln_visible[e.ln_ids[:nl]] += ln_vis[:nl]
        if self._carry is not None:
            self._carry = (self._carry[0], zero_stats(self._carry[1]))

        # Non-blocking poll of the previous keyframe's mapping chain —
        # generation guards in the apply paths make late application
        # safe, so keyframe creation no longer joins it (the reference's
        # Tracking thread doesn't wait for LocalMapping either).
        # Backpressure: only when 2+ chains are outstanding (the device
        # has fallen behind) join the oldest.
        with self.timing.stage("kf_join_prev_chain"):
            self.poll_map_jobs(force=len(self._map_jobs) >= 2)
            self.poll_pending_ba()
        # Drop associations invalidated by mapping since dispatch.
        assoc[assoc >= 0] = np.where(
            self.map.pt_valid[assoc[assoc >= 0]], assoc[assoc >= 0], -1
        )
        _tkf = time.perf_counter()
        kf = self.map.add_keyframe(
            fh, self.R, self.t, e.fid, e.ts, lm_assoc=assoc,
            parent=self.ref_kf,
        )
        self.timing.add("kf_add_keyframe", time.perf_counter() - _tkf)
        # New landmarks from stereo depth for unassociated features
        # (close ones always; mirrors Tracking::CreateNewKeyFrame).
        _tkf = time.perf_counter()
        depth = fh.depth
        valid = fh.valid
        baseline = cfg.camera.baseline
        assoc = self.map.kf_obs_lm[kf]
        candidates = np.nonzero(valid & (depth > 0) & (assoc < 0))[0]
        if len(candidates):
            order = candidates[np.argsort(depth[candidates])]
            close = depth[order] < cfg.tracking.th_depth * baseline
            n_close = close.sum()
            keep = order[close] if n_close >= 100 else order[:100]
            pts_c = nbackproject(cfg.camera, fh.xy, fh.depth)[keep]
            Rwc, twc = nse3_inverse(self.R, self.t)
            pts_w = nse3_apply(Rwc, twc, pts_c)
            ids = self.map.add_points(
                pts_w, fh.desc[keep], fh.octave[keep], kf, keep
            )
            self.recent_lm.append(ids)
        self.timing.add("kf_new_points", time.perf_counter() - _tkf)

        # Line landmarks: store this KF's line features; create 3D lines
        # from stereo endpoint depths for unmatched steep lines
        # (CreateNewMapLines analog).
        _tkf = time.perf_counter()
        if self.cfg.lines.enabled and e.lines is not None:
            # Host line features ride in the packed KF-event buffer —
            # a device_get of the pytree here would be serial
            # round-trips per keyframe.
            lf = (
                lf_host if lf_host is not None else jax.device_get(e.lines)
            )
            ln_assoc = np.full(lf.n, -1, np.int32)
            if e.ln_ids is not None and len(e.ln_ids):
                rows = np.nonzero(ln_mask)[0]
                rows = rows[rows < len(e.ln_ids)]
                ln_assoc[ln_idx[rows]] = e.ln_ids[rows]
            self.cur_ln_assoc = ln_assoc
            self.map.set_kf_lines(kf, lf, ln_assoc)
            new_ln = np.nonzero(
                lf.valid & (lf.depth0 > 0) & (lf.depth1 > 0) & (ln_assoc < 0)
            )[0]
            if len(new_ln):
                Rwc, twc = nse3_inverse(self.R, self.t)
                s_c = nbackproject(cfg.camera, lf.p0[new_ln], lf.depth0[new_ln])
                e_c = nbackproject(cfg.camera, lf.p1[new_ln], lf.depth1[new_ln])
                s_w = nse3_apply(Rwc, twc, s_c)
                e_w = nse3_apply(Rwc, twc, e_c)
                ids = self.map.add_lines(
                    s_w, e_w, lf.desc[new_ln], kf, new_ln
                )
                self.recent_ln.append(ids)
            # Line lifecycle (MapLine maintenance, SURVEY §2.1 rows 3,8):
            # fuse duplicates across keyframes, two-view triangulation
            # for segments without stereo depth (mono's ONLY 3D-line
            # source), distinctive-descriptor refresh.
            from ..slam_map.line_mapping import (
                create_lines_two_view,
                fuse_lines_into_keyframe,
            )

            fuse_lines_into_keyframe(self.map, kf, cfg.camera)
            if self.is_mono or len(new_ln) == 0:
                nbrs, _ = self.map.covisible_keyframes(kf, min_weight=10, max_n=1)
                if len(nbrs):
                    tri_ln = create_lines_two_view(
                        self.map, kf, int(nbrs[0]), cfg.camera
                    )
                    if len(tri_ln):
                        self.recent_ln.append(tri_ln)
            obs_ln = self.map.kf_ln_obs[kf]
            self.map.update_line_stats(obs_ln[obs_ln >= 0])

        self.timing.add("kf_lines_host", time.perf_counter() - _tkf)
        # Landmark stats for everything this KF observes.
        _tkf = time.perf_counter()
        seen = self.map.kf_obs_lm[kf]
        self.map.update_point_stats(seen[seen >= 0])
        self.timing.add("kf_point_stats", time.perf_counter() - _tkf)

        # --- local mapping step (async device jobs + host culling) ---
        _tkf = time.perf_counter()
        self._kf_frames[kf] = e.frame
        while len(self._kf_frames) > self._kf_frames_max:
            self._kf_frames.pop(next(iter(self._kf_frames)))
        if len(self.recent_lm) > 3:
            old = self.recent_lm.pop(0)
            self.map.cull_points(kf, old)
        if len(self.recent_ln) > 3:
            self.map.cull_lines(kf, self.recent_ln.pop(0))
        if self.map.n_keyframes() >= 3:
            if not self.async_mapping and self._pending_ba is not None:
                self.flush_pending_ba()
            # Redundant-keyframe culling over the local window.
            win, _ = self.map.covisible_keyframes(kf, min_weight=1, max_n=8)
            self.map.cull_keyframes([k for k in win if k != kf])

        self.timing.add("kf_cull_host", time.perf_counter() - _tkf)
        self.ref_kf = kf
        self._ref_frame_dev = e.frame
        self._ref_frame_kf = kf
        self.last_assoc = self.map.kf_obs_lm[kf].copy()
        # Tracking quality at creation time = the triggering frame's
        # inlier count (TrackedMapPoints analog; floor avoids KF
        # starvation in sparse scenes).
        self.ref_kf_matches = max(
            n_inliers or int((fh.valid & (assoc >= 0)).sum()), 40
        )

        # Loop closing runs BEFORE the mapping-chain dispatch: its small
        # device programs (BoW descent, Sim3 stages) would otherwise
        # queue behind ~300 ms of triangulation/fuse/BA work, turning
        # each of its fetches into a long stall.  Any loop correction
        # also lands before the chain is built, so the chain sees
        # corrected poses.
        if self.on_keyframe is not None:
            R_before = self.map.kf_R[kf].copy()
            t_before = self.map.kf_t[kf].copy()
            with self.timing.stage("loop_closing"):
                self.on_keyframe(kf)
            # A loop closure may have rewritten keyframe poses; ride
            # with the (possibly corrected) reference keyframe.
            self.R = self.map.kf_R[kf].copy()
            self.t = self.map.kf_t[kf].copy()
            if (
                np.abs(self.R - R_before).max() > 1e-5
                or np.abs(self.t - t_before).max() > 1e-4
            ):
                # Large correction: in-flight frames track a stale
                # world frame — re-anchor and drain (after this entry's
                # bookkeeping completes, to keep trajectory order).
                self.last_R, self.last_t = self.R.copy(), self.t.copy()
                self.vel = None
                self._carry = None
                self.last_frame = e.frame
                self._drain_required = True

        # Multi-view triangulation (CreateNewMapPoints) + cross-KF
        # duplicate fusion (SearchInNeighbors): ONE batched device
        # program each, dispatched now, applied by poll_map_jobs when
        # the device finishes (the reference's LocalMapping lag).
        if self.map.n_keyframes() >= 2:
            from ..slam_map.fuse import dispatch_fuse
            from ..slam_map.triangulation import dispatch_triangulation

            with self.timing.stage("map_jobs_dispatch"):
                # Refresh the device mirror NOW (post-mutation, pre-
                # dispatch): fuse gathers its landmark tables from the
                # mirror instead of uploading ~440 KB of host-packed
                # rows, and the
                # next frame's track_step reuses the same refresh.
                self._refresh_mirror(e.lines)
                # 3 neighbours: the 4th/5th covisible KF contributes <5%
                # new triangulations but each pair costs ~18 ms of
                # [N,N] epipolar+Hamming device traffic.
                ids, _ = self.map.covisible_keyframes(kf, min_weight=10, max_n=3)
                tri_job = dispatch_triangulation(
                    self.map, kf, ids, cfg.camera, cfg.orb.scale_factor,
                    kf_frames=self._kf_frames,
                )
                fuse_job = dispatch_fuse(
                    self.map, kf, ids, cfg.camera, cfg.orb.level_scales,
                    kf_frames=self._kf_frames, mirror=self._mir["pt"],
                )
            self._map_jobs.append(
                (kf, tri_job, fuse_job, time.monotonic(),
                 getattr(self.map, "pose_epoch", 0))
            )
            if not self.async_mapping:
                self.poll_map_jobs(force=True)
        else:
            self.mark_map_dirty()

    def warmup_mirror(self):
        """Pre-load the compiled mirror-refresh programs for EVERY delta
        bucket the pow2 ladder can produce.  Each first-use of a bucket
        in a fresh process pays a compile-cache load that dominates
        the pipeline when it lands inside a bench window."""
        from .mirror import (
            mirror_apply, mirror_apply_pos, mirror_from_flat,
        )

        m = self.map
        flat = np.zeros((m.P, 18), np.uint32)
        mir = mirror_from_flat(jnp.asarray(flat))
        # Buckets beyond local_points+slack never occur in steady state
        # (larger dirty sets take the full-refresh branch).
        b = 256
        while b <= min(m.P, 16384):
            dl = np.full((b, 19), 0xFFFFFFFF, np.uint32)
            dp = np.full((b, 4), 0xFFFFFFFF, np.uint32)
            mir = mirror_apply(mir, jnp.asarray(dl))
            mir = mirror_apply_pos(mir, jnp.asarray(dp))
            b *= 2
        jax.block_until_ready(mir.pos)

    def warmup_ba(self):
        """Pre-trace/compile the local-BA device program for every
        steady-state shape combo the observation/point buckets can
        produce (O crossing 12288→16384 or P crossing 4096→8192 as the
        map densifies would otherwise pay a ~1.5 s host retrace + XLA
        compile in the middle of a measured window).  Call from bench /
        profiling warmups; results are discarded."""
        mc = self.cfg.map
        cam = self.cfg.camera
        C = 24
        # Full cross product of the P and O bucket ladders (ADVICE r3
        # #3: a dense window can pair P=8192 with O=12288).
        combos = [(4096, 12288), (4096, 16384), (8192, 12288), (8192, 16384)]
        for P, O in combos:
            if P > mc.local_points or O > (mc.local_window + 16) * 512:
                continue
            args = (
                jnp.tile(jnp.eye(3, dtype=jnp.float32), (C, 1, 1)),
                jnp.zeros((C, 3), jnp.float32),
                jnp.ones(C, bool),
                jnp.zeros((P, 3), jnp.float32), jnp.zeros(P, bool),
                jnp.zeros(O, jnp.int32), jnp.zeros(O, jnp.int32),
                jnp.zeros((O, 3), jnp.float32), jnp.zeros(O, jnp.int32),
                jnp.zeros(O, bool),
            )
            if self.cfg.lines.enabled:
                from ..backend.line_ba import bundle_adjust_pl_flat

                Lc = self.cfg.lines.n_lines
                Lo = Lc * 8
                n_words = (
                    C * 13 + P * 4 + O * 3 + Lc * 12 + Lo * 3
                )
                res, _flat = bundle_adjust_pl_flat(
                    jnp.zeros(n_words, jnp.uint32),
                    C=C, P=P, O=O, L=Lc, Ol=Lo,
                    cam=cam, scale_factor=self.cfg.orb.scale_factor,
                )
            else:
                res = bundle_adjust(*args, cam, self.cfg.orb.scale_factor)
            jax.block_until_ready(res.chi2)

    def _local_ba(self, center_kf, defer: bool = False):
        """Local bundle adjustment.  With defer=True the device solve is
        dispatched asynchronously and written back by poll_pending_ba
        when it completes (or at the next keyframe at the latest) — the
        tracking loop never blocks on mapping, the property the
        reference gets from its LocalMapping pthread (SURVEY §7.2 #4)."""
        mc = self.cfg.map
        with self.timing.stage("ba_pack_host"):
            pack = self.map.pack_local_ba(
                center_kf,
                max_cams=mc.local_window + 16,
                max_points=mc.local_points,
                max_obs=(mc.local_window + 16) * 512,
            )
            # Stale-solve guard: a loop correction between dispatch and
            # apply makes this solve's poses pre-correction garbage.
            pack["pose_epoch"] = getattr(self.map, "pose_epoch", 0)
            lpack = None
            if self.cfg.lines.enabled:
                lpack = self.map.pack_line_obs(
                    pack["cam_ids"], max_lines=self.cfg.lines.n_lines,
                    max_lobs=self.cfg.lines.n_lines * 8,
                )
        if lpack is not None:
            from ..backend.line_ba import bundle_adjust_pl_flat, pack_pl_inputs
            from ..geometry.host import (
                northonormal_from_pluecker,
                npluecker_from_endpoints,
            )

            ids = lpack["ln_ids"]
            Lc = self.cfg.lines.n_lines
            s_w = np.zeros((Lc, 3), np.float32)
            e_w = np.ones((Lc, 3), np.float32)
            lval = np.zeros(Lc, bool)
            s_w[: len(ids)] = self.map.ln_start[ids]
            e_w[: len(ids)] = self.map.ln_end[ids]
            lval[: len(ids)] = True
            # Host math: eager jnp here would dispatch one-op XLA
            # programs per keyframe (geometry/host.py rationale).
            U0, w0 = northonormal_from_pluecker(
                *npluecker_from_endpoints(s_w, e_w)
            )
            # ONE packed upload for all solver inputs (instead of ~20
            # small transfers per keyframe), and the
            # result flattened INSIDE the solver program (a separate
            # flatten dispatch blocked ~70 ms at the System's queue
            # state); host unpack layout derives from the same statics.
            from ..backend.line_ba import pl_result_layout

            flat = pack_pl_inputs(pack, lpack, U0, w0, lval)
            C, P = pack["R"].shape[0], pack["points"].shape[0]
            O, Ol = pack["obs_cam"].shape[0], lpack["lobs_cam"].shape[0]
            _, flat_out = bundle_adjust_pl_flat(
                jnp.asarray(flat), C=C, P=P, O=O, L=Lc, Ol=Ol,
                cam=self.cfg.camera, scale_factor=self.cfg.orb.scale_factor,
            )
            treedef, shapes = pl_result_layout(C, P, O, Lc, Ol)
            fetch = (flat_out, treedef, shapes)
        else:
            res = bundle_adjust(
                jnp.asarray(pack["R"]), jnp.asarray(pack["t"]), jnp.asarray(pack["cam_fixed"]),
                jnp.asarray(pack["points"]), jnp.asarray(pack["point_valid"]),
                jnp.asarray(pack["obs_cam"]), jnp.asarray(pack["obs_lm"]),
                jnp.asarray(pack["obs_uvur"]), jnp.asarray(pack["obs_oct"]),
                jnp.asarray(pack["obs_valid"]), self.cfg.camera,
                self.cfg.orb.scale_factor,
            )
            # ONE packed device buffer for the whole result: fetching the
            # raw NamedTuple costs one round-trip per leaf.
            fetch = _pack_for_fetch(res)
        if defer:
            self._pending_ba = (pack, lpack, fetch, center_kf)
            self._pending_ba_t = time.monotonic()
            try:
                fetch[0].copy_to_host_async()
            except AttributeError:
                pass
            return
        self._apply_ba(pack, lpack, fetch, center_kf, ride=True)

    def _apply_ba(self, pack, lpack, fetch, center_kf, ride=False):
        packed, treedef, shapes = fetch
        with self.timing.stage("ba_apply"):
            res = _unpack_fetched(np.asarray(packed), treedef, shapes)
            with self.map.lock:
                self.map.apply_ba_result(pack, res)
                if lpack is not None:
                    self.map.apply_line_ba_result(
                        lpack, np.asarray(res.line_U), np.asarray(res.line_w),
                        np.asarray(res.lobs_inlier),
                    )
        self.mark_map_dirty()
        if ride:
            # Current pose rides with the reference KF.
            self.R = self.map.kf_R[center_kf].copy()
            self.t = self.map.kf_t[center_kf].copy()

    def flush_pending_ba(self):
        """Apply a deferred BA result (no-op if none pending).

        Discards the solve outright if a loop correction rewrote poses
        since dispatch (pose-epoch mismatch).  Otherwise the CURRENT
        tracked pose re-anchors by the reference keyframe's BA delta:
        without this the async write-back shears the live pose away
        from the map it is being matched against every keyframe
        interval (measured 0.24 -> 1.56 m ATE on the bench circuit —
        the sync path gets the same effect from ride=True)."""
        pending = self._pending_ba
        if pending is None:
            return
        pack, lpack, fetch, center_kf = pending
        self._pending_ba = None
        if pack.get("pose_epoch", 0) != getattr(self.map, "pose_epoch", 0):
            return  # stale: solved against pre-loop-correction poses
        k = self.ref_kf
        R0 = self.map.kf_R[k].copy()
        t0 = self.map.kf_t[k].copy()
        self._apply_ba(pack, lpack, fetch, center_kf, ride=False)
        R1, t1 = self.map.kf_R[k], self.map.kf_t[k]
        if (
            self.state == "OK"
            and (np.abs(R1 - R0).max() > 1e-7 or np.abs(t1 - t0).max() > 1e-7)
        ):
            # World-side correction W = T_ref_old^-1 ∘ T_ref_new (cw
            # matrices): the current pose experiences the same rigid
            # change as its reference keyframe's neighbourhood.
            W_R = R0.T @ R1
            W_t = R0.T @ (t1 - t0)
            self.t = (self.R @ W_t + self.t).astype(np.float32)
            self.R = (self.R @ W_R).astype(np.float32)
            self.last_t = (self.last_R @ W_t + self.last_t).astype(np.float32)
            self.last_R = (self.last_R @ W_R).astype(np.float32)
            if self._carry is not None:
                self._carry = (
                    self._carry[0],
                    override_carry(
                        self._carry[1], jnp.asarray(self.R), jnp.asarray(self.t)
                    ),
                )

    def poll_pending_ba(self):
        """Apply the deferred BA result iff the device solve finished.
        is_ready() polls are throttled: not before the solve plausibly finished,
        and at most every ~100 ms after."""
        pending = self._pending_ba
        if pending is None:
            return
        now = time.monotonic()
        if now - self._pending_ba_t < 0.1 or now < getattr(self, "_ba_next_poll", 0.0):
            return
        try:
            ready = pending[2][0].is_ready()
        except AttributeError:
            ready = True
        if ready:
            self.flush_pending_ba()
        else:
            self._ba_next_poll = now + 0.1

    def poll_map_jobs(self, force: bool = False):
        """Apply pending per-keyframe mapping jobs (triangulation +
        fuse) once their device programs finish, then dispatch the local
        BA for that keyframe.  Non-blocking unless force=True (at most
        one chain applied per non-forced poll, bounding the per-frame
        host hiccup); readiness polls are time-throttled."""
        from ..slam_map.fuse import apply_fuse
        from ..slam_map.triangulation import apply_triangulation

        while self._map_jobs:
            kf, tri_job, fuse_job, t_disp, disp_epoch = self._map_jobs[0]
            if not force:
                now = time.monotonic()
                if (
                    now - t_disp < 0.05
                    or now < getattr(self, "_jobs_next_poll", 0.0)
                ):
                    return
                for job in (tri_job, fuse_job):
                    if job is None:
                        continue
                    try:
                        if not job["packed"].is_ready():
                            self._jobs_next_poll = now + 0.1
                            return
                    except AttributeError:
                        pass
            self._map_jobs.pop(0)
            # Loop-corrected since dispatch: the searches projected
            # through pre-correction poses — matches and triangulated
            # positions are garbage in the corrected frame.
            stale = disp_epoch != getattr(self.map, "pose_epoch", 0)
            with self.timing.stage("map_jobs_apply"), self.map.lock:
                if not stale:
                    tri_ids = apply_triangulation(self.map, tri_job)
                    if len(tri_ids):
                        self.recent_lm.append(tri_ids)
                    apply_fuse(self.map, fuse_job)
            if self.map.n_keyframes() >= 3 and not self.localization_only:
                # mbAbortBA analog (SURVEY §3.3): when a newer keyframe's
                # chain is already queued behind this one, the reference
                # aborts local BA — skip the ~150 ms solve for this KF
                # (its window is re-optimized at the next quiet KF).
                # Bounded to 1 consecutive skip so BA can't starve
                # under sustained keyframe pressure.  Only in async
                # mode: the deterministic sync path never skips.
                if (
                    self.async_mapping
                    and len(self._map_jobs) >= 1
                    and getattr(self, "_ba_skips", 0)
                    < getattr(self, "ba_skip_limit", 1)
                ):
                    self._ba_skips = getattr(self, "_ba_skips", 0) + 1
                else:
                    self._ba_skips = 0
                    # One local BA in flight at a time: join the previous
                    # solve (dispatched a full keyframe interval ago —
                    # essentially always finished) before the next.
                    if self._pending_ba is not None:
                        self.flush_pending_ba()
                    center = kf if self.map.kf_valid[kf] else self.ref_kf
                    with self.timing.stage("local_ba_dispatch"):
                        self._local_ba(center, defer=self.async_mapping)
            self.mark_map_dirty()
            if not force:
                return
