"""Capacity-bounded SoA map store — the static-shape "map data model".

Replaces the reference's pointer-graph L1 layer (KeyFrame / MapPoint /
Map classes with per-object mutexes — src/{KeyFrame,MapPoint,Map}.cc,
SURVEY.md §1 L1, §7.0): keyframes, landmarks and observations live in
flat preallocated numpy arrays on the host (single-writer bookkeeping),
and device programs receive packed dense views.  Deletion is a mask
clear; culled keyframe slots are recycled through a free list (the
analog of KeyFrame::SetBadFlag's lazy deletion, with trajectory
re-anchoring to the spanning-tree parent), and the keyframe axis grows
by doubling when live keyframes outrun capacity, so arbitrarily long
sequences never freeze the map.

Observation model: each keyframe keeps its frame's feature slots
([F] per KF); ``kf_obs_lm[k, f]`` is the landmark id observed by
feature f of keyframe k (-1 = none) — the analog of
KeyFrame::mvpMapPoints, and the only place observations are stored
(MapPoint::mObservations is derived from it on demand).

Every derived structure (covisibility, observation counts) is cached
and invalidated by an observation epoch counter; all bulk maintenance
(distinctive descriptors, normals, merges, packing) is vectorized
numpy — no per-landmark Python loops on the hot path (the round-1
pipeline spent ~99% of wall time here; VERDICT.md "What's weak" #3).
"""

from __future__ import annotations

import threading

import numpy as np

from ..config import MapConfig

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


class MapStore:
    def __init__(self, cfg: MapConfig, n_features: int, n_lines: int = 0):
        self.cfg = cfg
        K, P, F = cfg.max_keyframes, cfg.max_points, n_features
        self.K, self.P, self.F = K, P, F

        # --- keyframes ---
        self.kf_valid = np.zeros(K, bool)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_frame_id = np.full(K, -1, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_parent = np.full(K, -1, np.int32)  # spanning tree (ChangeParent)
        # per-KF feature slots (copied from the source Frame)
        self.kf_xy = np.zeros((K, F, 2), np.float32)
        self.kf_ur = np.full((K, F), -1.0, np.float32)
        self.kf_depth = np.full((K, F), -1.0, np.float32)
        self.kf_oct = np.zeros((K, F), np.int32)
        self.kf_angle = np.zeros((K, F), np.float32)
        self.kf_desc = np.zeros((K, F, 32), np.uint8)
        self.kf_feat_valid = np.zeros((K, F), bool)
        self.kf_obs_lm = np.full((K, F), -1, np.int32)

        # --- landmarks (points) ---
        self.pt_valid = np.zeros(P, bool)
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 32), np.uint8)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_oct = np.zeros(P, np.int32)  # reference octave at creation
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_visible = np.zeros(P, np.int32)
        self.pt_found = np.zeros(P, np.int32)

        self._next_kf = 0                       # high-watermark (allocated)
        self._free_kfs: list[int] = []          # recycled culled slots
        self._free_pts = list(range(P - 1, -1, -1))
        self.on_kf_culled: list = []            # callbacks(kf_id, parent_id)
        # Generation counters: slots are RECYCLED (culling + merges), so
        # any consumer holding ids across async boundaries (deferred BA
        # write-back, in-flight triangulation/fuse jobs, loop edges, the
        # keyframe database) must stamp ids with the generation at
        # capture time and re-validate at use time — a recycled slot is
        # a different keyframe/landmark (VERDICT r2 weak #3).
        self.kf_gen = np.zeros(K, np.int64)
        self.pt_gen = np.zeros(P, np.int64)

        # epoch-stamped caches over kf_obs_lm / kf_valid
        self._obs_epoch = 0
        self._covis_cache = (-1, None)
        self._counts_cache = (-1, None)

        # Writer lock: the loop-detection worker thread snapshots map
        # state under this lock while the tracking thread holds it
        # across mutation windows (ADVICE r3 #1 — generation stamps
        # catch cull/recycle but not torn mixed-state reads).
        self.lock = threading.RLock()

        # landmark rows mutated since the last device-mirror refresh.
        # Two classes: full-row (new/culled/desc/stats changes) and
        # pos-only (BA write-back moves positions but leaves descriptors
        # and stats alone) — pos-only delta rows are 4 words instead of
        # 19, so the split moves ~5x fewer bytes on the dominant
        # refresh class.
        self._dirty_pts = np.zeros(P, bool)
        self._dirty_pos = np.zeros(P, bool)
        self._all_dirty = True

        # --- 3D line segments (MapLine analog, SURVEY.md §2.1 row 8) ---
        L = cfg.max_lines
        self.L = L
        self.Lf = n_lines  # line-feature slots per keyframe
        self.ln_valid = np.zeros(L, bool)
        self.ln_start = np.zeros((L, 3), np.float32)
        self.ln_end = np.zeros((L, 3), np.float32)
        self.ln_desc = np.zeros((L, 32), np.uint8)
        self.ln_first_kf = np.full(L, -1, np.int32)
        self.ln_visible = np.zeros(L, np.int32)
        self.ln_found = np.zeros(L, np.int32)
        self.ln_gen = np.zeros(L, np.int64)
        self._free_lines = list(range(L - 1, -1, -1))
        if n_lines:
            self.kf_ln_p0 = np.zeros((K, n_lines, 2), np.float32)
            self.kf_ln_p1 = np.zeros((K, n_lines, 2), np.float32)
            self.kf_ln_desc = np.zeros((K, n_lines, 32), np.uint8)
            self.kf_ln_valid = np.zeros((K, n_lines), bool)
            self.kf_ln_obs = np.full((K, n_lines), -1, np.int32)

    # ------------------------------------------------------------------
    # cache bookkeeping
    # ------------------------------------------------------------------
    def touch_obs(self):
        """Invalidate derived caches after any kf_obs_lm/kf_valid edit.
        External writers (tracking/fuse/triangulation) MUST call this."""
        self._obs_epoch += 1

    def mark_pts_dirty(self, ids, pos_only: bool = False):
        """Record landmark rows whose mirror fields changed.  pos_only
        marks rows where ONLY the position moved (BA write-back)."""
        tgt = self._dirty_pos if pos_only else self._dirty_pts
        tgt[np.asarray(ids, np.int64)] = True

    def mark_all_pts_dirty(self):
        """Bulk rewrite (loop correction, GBA, checkpoint load): force a
        full mirror refresh, and advance the pose epoch — in-flight
        async solves (local BA, triangulation, fuse) dispatched against
        the PRE-rewrite poses are stale and must be discarded at apply
        (the reference's mbStopGBA stale-solve semantics, extended to
        the per-keyframe mapping chain)."""
        self._all_dirty = True
        self.pose_epoch = getattr(self, "pose_epoch", 0) + 1

    def pop_dirty_pts(self):
        """(all_dirty, full_ids, pos_ids) — and reset the dirty sets."""
        all_dirty = self._all_dirty
        full = np.nonzero(self._dirty_pts)[0]
        pos = np.nonzero(self._dirty_pos & ~self._dirty_pts)[0]
        self._dirty_pts[:] = False
        self._dirty_pos[:] = False
        self._all_dirty = False
        return all_dirty, full, pos

    def _valid_kf_rows(self):
        return np.nonzero(self.kf_valid[: self._next_kf])[0]

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def _grow_keyframes(self):
        """Double keyframe capacity (host arrays only — device programs
        never consume K-sized inputs, so no recompiles)."""
        oldK, K = self.K, self.K * 2

        def g(a, fill=0):
            out = np.empty((K,) + a.shape[1:], a.dtype)
            out[:oldK] = a
            out[oldK:] = fill
            return out

        self.kf_valid = g(self.kf_valid, False)
        R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        R[:oldK] = self.kf_R
        self.kf_R = R
        self.kf_t = g(self.kf_t)
        self.kf_frame_id = g(self.kf_frame_id, -1)
        self.kf_timestamp = g(self.kf_timestamp)
        self.kf_parent = g(self.kf_parent, -1)
        self.kf_xy = g(self.kf_xy)
        self.kf_ur = g(self.kf_ur, -1.0)
        self.kf_depth = g(self.kf_depth, -1.0)
        self.kf_oct = g(self.kf_oct)
        self.kf_angle = g(self.kf_angle)
        self.kf_desc = g(self.kf_desc)
        self.kf_feat_valid = g(self.kf_feat_valid, False)
        self.kf_obs_lm = g(self.kf_obs_lm, -1)
        self.kf_gen = g(self.kf_gen, 0)
        if self.Lf:
            self.kf_ln_p0 = g(self.kf_ln_p0)
            self.kf_ln_p1 = g(self.kf_ln_p1)
            self.kf_ln_desc = g(self.kf_ln_desc)
            self.kf_ln_valid = g(self.kf_ln_valid, False)
            self.kf_ln_obs = g(self.kf_ln_obs, -1)
        self.K = K

    def add_keyframe(self, frame, R_cw, t_cw, frame_id, timestamp=0.0,
                     lm_assoc=None, parent=-1):
        """Insert a keyframe snapshot of `frame` (a frontend Frame pytree
        already on host or device). Returns the keyframe id."""
        if self._free_kfs:
            k = self._free_kfs.pop()
        else:
            if self._next_kf >= self.K:
                self._grow_keyframes()
            k = self._next_kf
            self._next_kf += 1
        self.kf_valid[k] = True
        self.kf_gen[k] += 1
        self.kf_R[k] = np.asarray(R_cw, np.float32)
        self.kf_t[k] = np.asarray(t_cw, np.float32)
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_parent[k] = parent if (parent != k) else -1
        self.kf_xy[k] = np.asarray(frame.xy)
        self.kf_ur[k] = np.asarray(frame.u_right)
        self.kf_depth[k] = np.asarray(frame.depth)
        self.kf_oct[k] = np.asarray(frame.octave)
        self.kf_angle[k] = np.asarray(frame.angle)
        self.kf_desc[k] = np.asarray(frame.desc)
        self.kf_feat_valid[k] = np.asarray(frame.valid)
        if lm_assoc is not None:
            assoc = np.asarray(lm_assoc, np.int32).copy()
            assoc[~self.kf_feat_valid[k]] = -1
            # Drop associations to dead landmarks.
            assoc[(assoc >= 0) & ~self.pt_valid[np.clip(assoc, 0, self.P - 1)]] = -1
            # A landmark may observe through ONE feature slot only
            # (duplicates arise when both stage-1 paths bound it).
            pos = assoc >= 0
            _, first = np.unique(assoc[pos], return_index=True)
            keep = np.zeros(pos.sum(), bool)
            keep[first] = True
            assoc[np.nonzero(pos)[0][~keep]] = -1
            self.kf_obs_lm[k] = assoc
        else:
            self.kf_obs_lm[k] = -1
        if self.Lf:
            self.kf_ln_valid[k] = False
            self.kf_ln_obs[k] = -1
        self.touch_obs()
        return k

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def set_kf_lines(self, kf_id, line_feat, ln_assoc=None):
        """Attach a keyframe's line features (frontend LineFeatures)."""
        if not self.Lf:
            return
        self.kf_ln_p0[kf_id] = np.asarray(line_feat.p0)
        self.kf_ln_p1[kf_id] = np.asarray(line_feat.p1)
        self.kf_ln_desc[kf_id] = np.asarray(line_feat.desc)
        self.kf_ln_valid[kf_id] = np.asarray(line_feat.valid)
        if ln_assoc is not None:
            a = np.asarray(ln_assoc, np.int32).copy()
            a[~self.kf_ln_valid[kf_id]] = -1
            a[(a >= 0) & ~self.ln_valid[np.clip(a, 0, self.L - 1)]] = -1
            self.kf_ln_obs[kf_id] = a

    # ------------------------------------------------------------------
    # lines
    # ------------------------------------------------------------------
    def add_lines(self, starts, ends, descs, kf_id, feat_idx):
        """Allocate new 3D line landmarks observed by (kf_id, feat_idx)."""
        n = min(len(starts), len(self._free_lines))
        ids = np.array([self._free_lines.pop() for _ in range(n)], np.int32)
        if n == 0:
            return ids
        self.ln_valid[ids] = True
        self.ln_gen[ids] += 1
        self.ln_start[ids] = np.asarray(starts, np.float32)[:n]
        self.ln_end[ids] = np.asarray(ends, np.float32)[:n]
        self.ln_desc[ids] = np.asarray(descs, np.uint8)[:n]
        self.ln_first_kf[ids] = kf_id
        self.ln_visible[ids] = 1
        self.ln_found[ids] = 1
        if self.Lf:
            self.kf_ln_obs[kf_id, np.asarray(feat_idx)[:n]] = ids
        return ids

    def erase_lines(self, ids):
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        live = ids[self.ln_valid[ids]]
        if len(live) == 0:
            return
        self.ln_valid[live] = False
        if self.Lf:
            dead = np.zeros(self.L + 1, bool)
            dead[live] = True
            rows = self._valid_kf_rows()
            obs = self.kf_ln_obs[rows]
            hit = dead[np.where(obs >= 0, obs, self.L)]
            self.kf_ln_obs[rows] = np.where(hit, -1, obs)
        self._free_lines.extend(int(i) for i in live)

    def line_obs_counts(self) -> np.ndarray:
        """Number of keyframe observations per line landmark, [L]."""
        counts = np.zeros(self.L + 1, np.int64)
        if self.Lf:
            obs = self.kf_ln_obs[self._valid_kf_rows()]
            np.add.at(counts, np.where(obs >= 0, obs, self.L).ravel(), 1)
        return counts[: self.L]

    def replace_lines(self, src_ids, dst_ids):
        """Batch-merge line landmarks src→dst (MapLine::Replace analog)."""
        src_ids = np.atleast_1d(np.asarray(src_ids, np.int64))
        dst_ids = np.atleast_1d(np.asarray(dst_ids, np.int64))
        keep = (
            (src_ids != dst_ids)
            & self.ln_valid[src_ids]
            & self.ln_valid[dst_ids]
        )
        src_ids, dst_ids = src_ids[keep], dst_ids[keep]
        if len(src_ids) == 0 or not self.Lf:
            return
        remap = np.arange(self.L + 1, dtype=np.int64)
        remap[src_ids] = dst_ids
        for _ in range(4):
            nxt = remap[remap]
            if np.array_equal(nxt, remap):
                break
            remap = nxt
        rows = self._valid_kf_rows()
        obs = self.kf_ln_obs[rows]
        idx = np.where(obs >= 0, obs, self.L)
        new = np.where(obs >= 0, remap[idx], -1).astype(np.int32)
        changed = (obs >= 0) & (new != obs)
        touched = changed.any(axis=1)
        rows_t = rows[touched]
        if len(rows_t):
            idx_t = idx[touched]
            new_t = new[touched]
            changed_t = changed[touched]
            pres = np.zeros((len(rows_t), self.L + 1), bool)
            pres[np.arange(len(rows_t))[:, None], idx_t] = True
            conflict = changed_t & pres[
                np.arange(len(rows_t))[:, None],
                np.where(changed_t, new_t, self.L),
            ]
            new_t = np.where(conflict, -1, new_t)
            self.kf_ln_obs[rows_t] = _dedup_rows(new_t, self.L)
        np.add.at(self.ln_found, remap[src_ids], self.ln_found[src_ids])
        np.add.at(self.ln_visible, remap[src_ids], self.ln_visible[src_ids])
        self.ln_valid[src_ids] = False
        self._free_lines.extend(int(i) for i in np.unique(src_ids))

    def update_line_stats(self, ln_ids):
        """Distinctive descriptor per line landmark: min median Hamming
        over its keyframe observations (MapLine mirrors MapPoint's
        ComputeDistinctiveDescriptors — SURVEY.md §2.1 row 8)."""
        if not self.Lf:
            return
        ln_ids = np.atleast_1d(np.asarray(ln_ids, np.int64))
        ln_ids = np.unique(ln_ids[self.ln_valid[ln_ids]])
        n = len(ln_ids)
        if n == 0:
            return
        lookup = np.full(self.L, -1, np.int32)
        lookup[ln_ids] = np.arange(n, dtype=np.int32)
        rows = self._valid_kf_rows()
        obs = self.kf_ln_obs[rows]
        li = np.where(obs >= 0, lookup[np.clip(obs, 0, self.L - 1)], -1)
        ks, fs = np.nonzero(li >= 0)
        g = li[ks, fs]
        order = np.argsort(g, kind="stable")
        g, ks, fs = g[order], ks[order], fs[order]
        descs = self.kf_ln_desc[rows[ks], fs]
        _scatter_distinctive(self.ln_desc, ln_ids, g, descs, n)

    # ------------------------------------------------------------------
    # landmarks
    # ------------------------------------------------------------------
    def add_points(self, positions, descs, octaves, kf_id, feat_idx):
        """Allocate new landmarks observed by (kf_id, feat_idx). Returns ids."""
        n = len(positions)
        if n > len(self._free_pts):
            n = len(self._free_pts)
        ids = np.array([self._free_pts.pop() for _ in range(n)], np.int32)
        if n == 0:
            return ids
        positions = np.asarray(positions, np.float32)[:n]
        self.pt_valid[ids] = True
        self.pt_gen[ids] += 1
        self.pt_pos[ids] = positions
        self.pt_desc[ids] = np.asarray(descs, np.uint8)[:n]
        self.pt_oct[ids] = np.asarray(octaves, np.int32)[:n]
        self.pt_first_kf[ids] = kf_id
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.kf_obs_lm[kf_id, np.asarray(feat_idx)[:n]] = ids
        self.touch_obs()
        # viewing geometry
        cam_center = -self.kf_R[kf_id].T @ self.kf_t[kf_id]
        d = positions - cam_center
        dist = np.linalg.norm(d, axis=-1) + 1e-9
        self.pt_normal[ids] = d / dist[:, None]
        oc = self.pt_oct[ids].astype(np.float64)
        # The extra 1.2 calibrates PredictScale to THIS detector: our
        # per-cell top-K favors one-coarser levels than OpenCV's octree,
        # so the expected octave at the creation distance is ~1, not 0.
        self.pt_max_dist[ids] = dist * (1.2 ** oc) * 1.2
        self.pt_min_dist[ids] = self.pt_max_dist[ids] / (1.2 ** 8)
        self.mark_pts_dirty(ids)
        return ids

    def erase_point(self, ids):
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        live = ids[self.pt_valid[ids]]
        if len(live) == 0:
            return
        self.pt_valid[live] = False
        self.mark_pts_dirty(live)
        dead = np.zeros(self.P + 1, bool)
        dead[live] = True
        rows = self._valid_kf_rows()
        obs = self.kf_obs_lm[rows]
        hit = dead[np.where(obs >= 0, obs, self.P)]
        self.kf_obs_lm[rows] = np.where(hit, -1, obs)
        self.touch_obs()
        self._free_pts.extend(int(i) for i in live)

    def replace_points(self, src_ids, dst_ids):
        """Batch-merge landmarks src→dst (MapPoint::Replace): every
        observation slot holding src is rebound to dst, except in
        keyframes that already observe dst (slot cleared — a feature
        can't observe the same landmark twice). found/visible counters
        accumulate into the survivor. Merge chains are resolved first."""
        src_ids = np.atleast_1d(np.asarray(src_ids, np.int64))
        dst_ids = np.atleast_1d(np.asarray(dst_ids, np.int64))
        keep = (
            (src_ids != dst_ids)
            & self.pt_valid[src_ids]
            & self.pt_valid[dst_ids]
        )
        src_ids, dst_ids = src_ids[keep], dst_ids[keep]
        if len(src_ids) == 0:
            return
        remap = np.arange(self.P + 1, dtype=np.int64)
        remap[src_ids] = dst_ids
        for _ in range(4):  # chains (a→b, b→c) are shallow in practice
            nxt = remap[remap]
            if np.array_equal(nxt, remap):
                break
            remap = nxt
        rows = self._valid_kf_rows()
        obs = self.kf_obs_lm[rows]
        idx = np.where(obs >= 0, obs, self.P)
        new = np.where(obs >= 0, remap[idx], -1).astype(np.int32)
        changed = (obs >= 0) & (new != obs)
        # Restrict all remaining work to rows that actually contain a
        # remapped slot — a dense [K, P] presence matrix over every
        # valid keyframe was a ~65 MB allocation per merge batch at
        # full map scale (ADVICE r2 #5).
        touched = changed.any(axis=1)
        rows_t = rows[touched]
        if len(rows_t) == 0:
            new_rows = None
        else:
            obs_t = obs[touched]
            idx_t = idx[touched]
            new_t = new[touched]
            changed_t = changed[touched]
            # Conflict: the row already observed dst natively → clear
            # the remapped slot (keep the original observation).
            pres = np.zeros((len(rows_t), self.P + 1), bool)
            pres[np.arange(len(rows_t))[:, None], idx_t] = True
            conflict = changed_t & pres[
                np.arange(len(rows_t))[:, None],
                np.where(changed_t, new_t, self.P),
            ]
            new_t = np.where(conflict, -1, new_t)
            # Two srcs merging into one dst in the same row: keep first.
            new_rows = _dedup_rows(new_t, self.P)
        if new_rows is not None:
            self.kf_obs_lm[rows_t] = new_rows
        np.add.at(self.pt_found, remap[src_ids], self.pt_found[src_ids])
        np.add.at(self.pt_visible, remap[src_ids], self.pt_visible[src_ids])
        self.pt_valid[src_ids] = False
        self.mark_pts_dirty(src_ids)
        self.touch_obs()
        self._free_pts.extend(int(i) for i in np.unique(src_ids))

    def point_observations(self, lm_ids):
        """For each landmark id: list of (kf, feat) observing it."""
        lm_ids = np.atleast_1d(np.asarray(lm_ids, np.int64))
        out = {int(i): [] for i in lm_ids}
        if len(lm_ids) == 0:
            return out
        g, kk, ff = self._gather_obs(np.unique(lm_ids))
        uniq = np.unique(lm_ids)
        for gi, k, f in zip(uniq[g], kk, ff):
            out[int(gi)].append((int(k), int(f)))
        return out

    def obs_counts(self) -> np.ndarray:
        """Number of keyframe observations per landmark, [P] (cached)."""
        epoch, cached = self._counts_cache
        if epoch == self._obs_epoch:
            return cached
        counts = np.zeros(self.P + 1, np.int64)
        obs = self.kf_obs_lm[self._valid_kf_rows()]
        np.add.at(counts, np.where(obs >= 0, obs, self.P).ravel(), 1)
        counts = counts[: self.P]
        self._counts_cache = (self._obs_epoch, counts)
        return counts

    def _gather_obs(self, lm_ids):
        """All observations of lm_ids as flat arrays (g, kf, feat),
        sorted by landmark-local index g (stable: kf ascending within
        each group). lm_ids must be unique."""
        n = len(lm_ids)
        lookup = np.full(self.P, -1, np.int32)
        lookup[lm_ids] = np.arange(n, dtype=np.int32)
        rows = self._valid_kf_rows()
        obs = self.kf_obs_lm[rows]
        li = np.where(obs >= 0, lookup[np.clip(obs, 0, self.P - 1)], -1)
        ks, fs = np.nonzero(li >= 0)
        g = li[ks, fs]
        order = np.argsort(g, kind="stable")
        return g[order], rows[ks[order]], fs[order]

    # ------------------------------------------------------------------
    # covisibility (derived, cached per observation epoch)
    # ------------------------------------------------------------------
    def covisibility(self) -> np.ndarray:
        """Weighted covisibility matrix [K, K]: #shared landmarks.

        Derived from kf_obs_lm (KeyFrame::UpdateConnections recomputes
        per insertion; we recompute per observation epoch) as S·Sᵀ of
        the sparse KF×landmark incidence matrix."""
        epoch, cached = self._covis_cache
        if epoch == self._obs_epoch:
            return cached
        import scipy.sparse as sp

        Kn = self._next_kf
        W = np.zeros((Kn, Kn), np.int32)
        rows = self._valid_kf_rows()
        if len(rows):
            obs = self.kf_obs_lm[rows]
            ks, fs = np.nonzero(obs >= 0)
            lm = obs[ks, fs]
            S = sp.csr_matrix(
                (np.ones(len(lm), np.int32), (rows[ks], lm)),
                shape=(Kn, self.P),
            )
            W = np.asarray((S @ S.T).todense(), np.int32)
            np.fill_diagonal(W, 0)
        self._covis_cache = (self._obs_epoch, W)
        return W

    def covisible_keyframes(self, kf_id, min_weight=15, max_n=None):
        W = self.covisibility()
        w = W[kf_id]
        ids = np.nonzero(w >= min_weight)[0]
        ids = ids[np.argsort(-w[ids])]
        if max_n is not None:
            ids = ids[:max_n]
        return ids, w[ids]

    # ------------------------------------------------------------------
    # descriptor / normal maintenance
    # ------------------------------------------------------------------
    def update_point_stats(self, lm_ids):
        """Recompute distinctive descriptor (min median Hamming), mean
        viewing normal, and scale range (MapPoint::
        ComputeDistinctiveDescriptors / UpdateNormalAndDepth) for the
        given landmarks — one vectorized pass, no per-landmark loops."""
        lm_ids = np.atleast_1d(np.asarray(lm_ids, np.int64))
        lm_ids = np.unique(lm_ids[self.pt_valid[np.clip(lm_ids, 0, self.P - 1)]])
        n = len(lm_ids)
        if n == 0:
            return
        g, kk, ff = self._gather_obs(lm_ids)
        if len(g) == 0:
            return
        starts = np.searchsorted(g, np.arange(n))
        ends = np.searchsorted(g, np.arange(n) + 1)
        cnt = ends - starts
        has = cnt > 0

        # --- mean viewing normal ---
        centers = -np.einsum("kji,kj->ki", self.kf_R[kk], self.kf_t[kk])
        d = self.pt_pos[lm_ids[g]] - centers
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
        nsum = np.zeros((n, 3), np.float64)
        np.add.at(nsum, g, d)
        norm = np.linalg.norm(nsum, axis=-1, keepdims=True) + 1e-9
        navg = (nsum / norm).astype(np.float32)
        self.pt_normal[lm_ids[has]] = navg[has]

        # --- scale-invariance range from the newest observation
        # (groups are kf-ascending, so the group's last element) ---
        ref = np.maximum(ends - 1, 0)
        k_ref, f_ref = kk[ref], ff[ref]
        c_ref = -np.einsum("kji,kj->ki", self.kf_R[k_ref], self.kf_t[k_ref])
        dist_ref = np.linalg.norm(self.pt_pos[lm_ids] - c_ref, axis=-1)
        oc = self.kf_oct[k_ref, f_ref].astype(np.float64)
        maxd = (dist_ref * (1.2 ** oc) * 1.2).astype(np.float32)
        self.pt_max_dist[lm_ids[has]] = maxd[has]
        self.pt_min_dist[lm_ids[has]] = (maxd / (1.2 ** 8))[has]

        # --- distinctive descriptor ---
        descs = self.kf_desc[kk, ff]
        _scatter_distinctive(self.pt_desc, lm_ids, g, descs, n)
        self.mark_pts_dirty(lm_ids)

    # ------------------------------------------------------------------
    # culling
    # ------------------------------------------------------------------
    def cull_points(self, current_kf: int, recent_ids):
        """MapPointCulling: drop recently-created landmarks that are
        under-observed or rarely found (SURVEY.md §3.3)."""
        recent_ids = np.asarray(recent_ids, np.int64)
        if len(recent_ids) == 0:
            return np.array([], np.int32)
        recent_ids = recent_ids[self.pt_valid[recent_ids]]
        counts = self.obs_counts()
        found_ratio = self.pt_found[recent_ids] / np.maximum(
            self.pt_visible[recent_ids], 1
        )
        age = current_kf - self.pt_first_kf[recent_ids]
        bad = (found_ratio < 0.25) | ((age >= 2) & (counts[recent_ids] <= 2))
        doomed = recent_ids[bad]
        self.erase_point(doomed)
        return doomed

    def cull_lines(self, current_kf: int, recent_ids):
        """MapLineCulling: same policy as points for fresh 3D lines."""
        recent_ids = np.asarray(recent_ids, np.int64)
        if len(recent_ids) == 0 or not self.Lf:
            return np.array([], np.int32)
        recent_ids = recent_ids[self.ln_valid[recent_ids]]
        counts = self.line_obs_counts()
        found_ratio = self.ln_found[recent_ids] / np.maximum(
            self.ln_visible[recent_ids], 1
        )
        age = current_kf - self.ln_first_kf[recent_ids]
        bad = (found_ratio < 0.25) | ((age >= 2) & (counts[recent_ids] <= 1))
        doomed = recent_ids[bad]
        self.erase_lines(doomed)
        return doomed

    def erase_keyframe(self, k: int):
        """SetBadFlag: free the slot, splice the spanning tree (children
        re-parent to k's parent), re-anchor landmark refs, notify
        listeners (trajectory re-anchor + KeyFrameDatabase.erase)."""
        if not self.kf_valid[k]:
            return
        parent = int(self.kf_parent[k])
        self.kf_valid[k] = False
        self.kf_obs_lm[k] = -1
        self.kf_feat_valid[k] = False
        if self.Lf:
            self.kf_ln_obs[k] = -1
            self.kf_ln_valid[k] = False
        # spanning-tree splice
        kids = np.nonzero(self.kf_parent[: self._next_kf] == k)[0]
        self.kf_parent[kids] = parent
        # landmark home-KF re-anchor
        self.pt_first_kf[self.pt_first_kf == k] = parent
        self.ln_first_kf[self.ln_first_kf == k] = parent
        self.touch_obs()
        for cb in self.on_kf_culled:
            cb(int(k), parent)
        self._free_kfs.append(int(k))

    def cull_keyframes(self, window_ids):
        """KeyFrameCulling: a KF whose landmarks are ≥90% seen by ≥3
        other KFs at same-or-finer scale is redundant (SURVEY.md §3.3)."""
        counts = self.obs_counts()
        culled = []
        for k in window_ids:
            if k == 0 or not self.kf_valid[k]:
                continue
            lm = self.kf_obs_lm[k]
            lm = lm[lm >= 0]
            if len(lm) < 20:
                continue
            redundant = (counts[lm] >= 4).mean()  # self + 3 others
            if redundant > 0.9:
                self.erase_keyframe(int(k))
                culled.append(int(k))
        return culled

    # ------------------------------------------------------------------
    # dense views for device programs
    # ------------------------------------------------------------------
    def pack_local_ba(self, center_kf: int, max_cams: int, max_points: int,
                      max_obs: int, min_covis: int = 1, all_free: bool = False):
        """Assemble the local-BA window around center_kf.

        Free cameras: center + best covisible KFs (up to local_window).
        Fixed cameras: other KFs observing the window's landmarks.
        Returns dict of padded arrays for backend.local_ba.bundle_adjust
        plus index maps for write-back.  Fully vectorized packing."""
        cfg = self.cfg
        if all_free:
            # Global BA: every valid keyframe is a free vertex.
            window = [int(k) for k in self._valid_kf_rows()][:max_cams]
        else:
            W = self.covisibility()
            w = W[center_kf].copy()
            w[~self.kf_valid[: len(w)]] = 0
            order = np.argsort(-w)
            window = [center_kf] + [
                int(k) for k in order if w[k] >= min_covis and k != center_kf
            ][: cfg.local_window - 1]

        # Landmarks seen from the window.
        wobs = self.kf_obs_lm[window]
        lm_set = np.unique(wobs[wobs >= 0])
        lm_set = lm_set[self.pt_valid[lm_set]][:max_points]
        # One coarse step only: each distinct (C, P, O) combo costs a
        # ~1 s host retrace of the BA program (+ compile on cold cache),
        # so the ladder must stabilize after the map's first growth.
        for p_b in (4096,):
            if len(lm_set) <= p_b <= max_points:
                max_points = p_b
                break
        lm_lookup = np.full(self.P, -1, np.int32)
        lm_lookup[lm_set] = np.arange(len(lm_set), dtype=np.int32)

        # Fixed cameras: any other valid KF observing those landmarks.
        rows = self._valid_kf_rows()
        in_window = np.zeros(self._next_kf, bool)
        in_window[window] = True
        others = rows[~in_window[rows]]
        if len(others) and not all_free:
            oobs = self.kf_obs_lm[others]
            hits = (oobs >= 0) & (
                lm_lookup[np.clip(oobs, 0, self.P - 1)] >= 0
            )
            n_hits = hits.sum(axis=1)
            order_f = np.argsort(-n_hits)
            fixed = [int(others[i]) for i in order_f if n_hits[i] > 0]
        else:
            fixed = []
        # Keep gauge: if no fixed cams, fix the oldest window cam.
        # Boundary (fixed) cameras capped at the 8 strongest anchors:
        # beyond those they only add padded rows.
        if not all_free:
            max_cams = min(max_cams, max(len(window), 16) + 8)
        cams = window + fixed[: max_cams - len(window)]
        cam_fixed = np.array(
            [False] * len(window) + [True] * (len(cams) - len(window))
        )
        if not cam_fixed.any():
            cam_fixed[np.argmin([self.kf_frame_id[k] for k in cams])] = True

        # Bucketed padding: the BA kernel's per-iteration cost scales
        # with the PADDED (C, P, O) — at small maps, padding to full
        # capacity wastes ~4x device time per solve (260 -> 70 ms
        # measured).  ONE fixed bucket per dimension: every distinct
        # (C, P, O) combo costs a ~1 s host retrace (+ XLA compile on a
        # cold cache), so the shape must be identical across keyframes.
        C = min(24, max_cams) if not all_free else max_cams
        cams = cams[:C]
        cam_fixed = cam_fixed[:C]
        R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t = np.zeros((C, 3), np.float32)
        fixed_mask = np.ones(C, bool)
        cams_arr = np.asarray(cams, np.int64)
        R[: len(cams)] = self.kf_R[cams_arr]
        t[: len(cams)] = self.kf_t[cams_arr]
        fixed_mask[: len(cams)] = cam_fixed

        # Observations (vectorized over the cams' feature slots).
        cobs = self.kf_obs_lm[cams_arr]
        local = lm_lookup[np.clip(cobs, 0, self.P - 1)]
        sel = (cobs >= 0) & (local >= 0)
        ci, fi = np.nonzero(sel)
        O = max_obs
        for o_b in (12288,):
            if len(ci) <= o_b <= max_obs:
                O = o_b
                break
        n_obs = min(len(ci), O)
        ci, fi = ci[:n_obs], fi[:n_obs]
        kfi = cams_arr[ci]
        obs_cam = np.zeros(O, np.int32)
        obs_lm = np.zeros(O, np.int32)
        obs_uvur = np.zeros((O, 3), np.float32)
        obs_oct = np.zeros(O, np.int32)
        obs_valid = np.zeros(O, bool)
        obs_kf = np.zeros(O, np.int32)
        obs_feat = np.zeros(O, np.int32)
        if n_obs:
            obs_cam[:n_obs] = ci
            obs_lm[:n_obs] = local[ci, fi]
            obs_uvur[:n_obs, :2] = self.kf_xy[kfi, fi]
            obs_uvur[:n_obs, 2] = self.kf_ur[kfi, fi]
            obs_oct[:n_obs] = self.kf_oct[kfi, fi]
            obs_valid[:n_obs] = True
            obs_kf[:n_obs] = kfi
            obs_feat[:n_obs] = fi

        pts = np.zeros((max_points, 3), np.float32)
        pt_valid = np.zeros(max_points, bool)
        pts[: len(lm_set)] = self.pt_pos[lm_set]
        pt_valid[: len(lm_set)] = True

        return {
            "R": R, "t": t, "cam_fixed": fixed_mask,
            "points": pts, "point_valid": pt_valid,
            "obs_cam": obs_cam, "obs_lm": obs_lm, "obs_uvur": obs_uvur,
            "obs_oct": obs_oct, "obs_valid": obs_valid,
            "cam_ids": cams_arr.astype(np.int32),
            "lm_ids": lm_set.astype(np.int32),
            "obs_kf": obs_kf, "obs_feat": obs_feat,
            "n_obs": n_obs,
            # Generation stamps: the solve may be applied frames later
            # (deferred async BA); recycled slots must not be written.
            "cam_gens": self.kf_gen[cams_arr].copy(),
            "lm_gens": self.pt_gen[lm_set].copy(),
        }

    def pack_line_obs(self, cam_ids, max_lines: int, max_lobs: int):
        """Line observations of the given keyframes, for the joint
        point+line bundle adjuster (indices local to cam_ids order)."""
        if not self.Lf:
            return None
        cam_ids = np.asarray(cam_ids, np.int64)
        cobs = self.kf_ln_obs[cam_ids]
        ln_set = np.unique(cobs[cobs >= 0])
        ln_set = ln_set[self.ln_valid[ln_set]][:max_lines]
        if len(ln_set) == 0:
            return None
        lookup = np.full(self.L, -1, np.int32)
        lookup[ln_set] = np.arange(len(ln_set), dtype=np.int32)

        local = lookup[np.clip(cobs, 0, self.L - 1)]
        sel = (cobs >= 0) & (local >= 0)
        ci, si = np.nonzero(sel)
        n = min(len(ci), max_lobs)
        ci, si = ci[:n], si[:n]
        kfi = cam_ids[ci]
        out = {
            "ln_ids": ln_set.astype(np.int32),
            "ln_gens": self.ln_gen[ln_set].copy(),
            "lobs_cam": np.zeros(max_lobs, np.int32),
            "lobs_ln": np.zeros(max_lobs, np.int32),
            "lobs_a": np.zeros((max_lobs, 2), np.float32),
            "lobs_b": np.zeros((max_lobs, 2), np.float32),
            "lobs_valid": np.zeros(max_lobs, bool),
            "lobs_kf": np.zeros(max_lobs, np.int32),
            "lobs_slot": np.zeros(max_lobs, np.int32),
            "n_lobs": n,
        }
        if n:
            out["lobs_cam"][:n] = ci
            out["lobs_ln"][:n] = local[ci, si]
            out["lobs_a"][:n] = self.kf_ln_p0[kfi, si]
            out["lobs_b"][:n] = self.kf_ln_p1[kfi, si]
            out["lobs_valid"][:n] = True
            out["lobs_kf"][:n] = kfi
            out["lobs_slot"][:n] = si
        return out

    def apply_line_ba_result(self, lpack, line_U, line_w, lobs_inlier):
        """Write back optimized 3D lines (endpoints re-anchored by
        closest-point projection onto the optimized infinite line).
        Pure host numpy: variable-length ids would recompile eager XLA
        ops at every keyframe."""
        from ..geometry.host import (
            nclosest_points_on_line,
            npluecker_from_orthonormal,
        )

        ids = lpack["ln_ids"]
        live = self.ln_valid[ids] & (self.ln_gen[ids] == lpack["ln_gens"])
        n, v = npluecker_from_orthonormal(
            np.asarray(line_U[: len(ids)]), np.asarray(line_w[: len(ids)])
        )
        idw = ids[live]
        self.ln_start[idw] = nclosest_points_on_line(
            n[live], v[live], self.ln_start[idw]
        )
        self.ln_end[idw] = nclosest_points_on_line(n[live], v[live], self.ln_end[idw])
        inl = np.asarray(lobs_inlier)
        nlo = lpack["n_lobs"]
        bad = np.nonzero(
            ~inl[:nlo] & lpack["lobs_valid"][:nlo] & live[lpack["lobs_ln"][:nlo]]
        )[0]
        if len(bad):
            self.kf_ln_obs[lpack["lobs_kf"][bad], lpack["lobs_slot"][bad]] = -1

    def apply_ba_result(self, pack, result, erase_outliers: bool = True):
        """Write back optimized poses/points; erase outlier observations
        (erase_outliers=False for the loop-closure global BA, which runs
        robust single-stage and must not strip low-support keyframes).

        Rows whose slot was culled+recycled since pack time (generation
        mismatch) are skipped — the deferred solve would otherwise write
        a stale pose/position into an unrelated keyframe/landmark."""
        cams = pack["cam_ids"]
        fixed = pack["cam_fixed"][: len(cams)]
        R = np.asarray(result.R)
        t = np.asarray(result.t)
        cam_live = self.kf_valid[cams] & (self.kf_gen[cams] == pack["cam_gens"])
        free = ~fixed & cam_live
        self.kf_R[cams[free]] = R[: len(cams)][free]
        self.kf_t[cams[free]] = t[: len(cams)][free]
        lm_ids = pack["lm_ids"]
        lm_live = self.pt_valid[lm_ids] & (self.pt_gen[lm_ids] == pack["lm_gens"])
        lm_w = lm_ids[lm_live]
        self.pt_pos[lm_w] = np.asarray(result.points)[: len(lm_ids)][lm_live]
        self.mark_pts_dirty(lm_w, pos_only=True)
        if not erase_outliers:
            return
        inl = np.asarray(result.obs_inlier)
        n_obs = pack["n_obs"]
        obs_live = cam_live[pack["obs_cam"][:n_obs]]
        # Only erase a feature binding that still points at the SAME
        # landmark it did at pack time (fuse may have re-bound it).
        still_bound = (
            self.kf_obs_lm[pack["obs_kf"][:n_obs], pack["obs_feat"][:n_obs]]
            == lm_ids[pack["obs_lm"][:n_obs]]
        )
        bad = np.nonzero(
            ~inl[:n_obs] & pack["obs_valid"][:n_obs] & obs_live & still_bound
        )[0]
        if len(bad):
            self.kf_obs_lm[pack["obs_kf"][bad], pack["obs_feat"][bad]] = -1
            self.touch_obs()


def _dedup_rows(obs: np.ndarray, cap: int) -> np.ndarray:
    """Clear duplicate landmark ids within each row of obs [K, F]
    (keeps the first occurrence; -1 entries are ignored)."""
    K, F = obs.shape
    key = obs.astype(np.int64) + np.arange(K, dtype=np.int64)[:, None] * (cap + 2)
    key = np.where(obs >= 0, key, -1)
    flat = key.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_keys = flat[order]
    dup_sorted = np.zeros(len(flat), bool)
    dup_sorted[1:] = (sorted_keys[1:] == sorted_keys[:-1]) & (sorted_keys[1:] >= 0)
    dup = np.zeros(len(flat), bool)
    dup[order] = dup_sorted
    out = obs.copy().ravel()
    out[dup] = -1
    return out.reshape(K, F)


def _scatter_distinctive(dest: np.ndarray, ids: np.ndarray, g: np.ndarray,
                         descs: np.ndarray, n: int, gmax: int = 24):
    """Per-group min-median-Hamming descriptor (the reference's
    ComputeDistinctiveDescriptors), batched: groups padded to gmax,
    pairwise Hamming via bit matmul, write into dest[ids]."""
    if len(g) == 0:
        return
    starts = np.searchsorted(g, np.arange(n))
    cnt = np.searchsorted(g, np.arange(n) + 1) - starts
    slot = np.arange(len(g)) - starts[g]
    keep = slot < gmax
    G = int(min(max(cnt.max(), 1), gmax))
    D = np.zeros((n, G, 32), np.uint8)
    D[g[keep], slot[keep]] = descs[keep]
    ccap = np.minimum(cnt, G)
    vmask = np.arange(G)[None, :] < ccap[:, None]
    bits = np.unpackbits(D, axis=2).astype(np.float32)  # [n, G, 256]
    cross = np.einsum("ngb,nhb->ngh", bits, 1.0 - bits)
    dist = cross + cross.transpose(0, 2, 1)
    dist[~vmask[:, None, :].repeat(G, 1)] = np.inf  # invalid columns
    ds = np.sort(dist, axis=2)
    med_idx = np.maximum((ccap - 1) // 2, 0)
    med = np.take_along_axis(
        ds, med_idx[:, None, None].repeat(G, 1), axis=2
    )[:, :, 0]
    med[~vmask] = np.inf
    best = np.argmin(med, axis=1)
    has = ccap > 0
    dest[ids[has]] = D[np.arange(n)[has], best[has]]
