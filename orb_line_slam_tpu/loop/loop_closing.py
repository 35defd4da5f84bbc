"""Loop detection + correction orchestration.

Rebuilds src/LoopClosing.cc (SURVEY.md §2.1 row 4, §3.4): per-keyframe
BoW candidate detection with 3-consecutive-keyframe covisibility
consistency, Sim3 computation (batched RANSAC + guided matching),
CorrectLoop (Sim3 propagation over the covisible group, landmark fuse,
essential-graph optimization, global BA).  Runs synchronously when the
host loop calls `process_keyframe` (the reference's thread handoff
becomes a per-keyframe call; asynchrony is the host's choice).
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..backend.local_ba import bundle_adjust
from ..backend.pose_graph import optimize_pose_graph
from ..backend.sim3_opt import optimize_sim3
from ..backend.sim3_solver import solve_sim3_ransac
from ..config import SlamConfig
from ..geometry.host import (
    nse3_apply,
    nse3_compose,
    nse3_inverse,
    nse3_relative,
    nsim3_apply,
    nsim3_compose,
    nsim3_inverse,
)
from ..matching.point_matcher import match_descriptors, search_by_sim3_dir
from ..slam_map.keyframe_db import KeyFrameDatabase
from ..slam_map.map_store import MapStore
from .vocabulary import Vocabulary


class _ShardedGBAResult:
    """BAResult-compatible view over a distributed-GBA solve: poses and
    chi2 pass through; `points` drops the shard padding; `obs_inlier`
    is remapped from shard-grouped order back to the pack's observation
    order on first (host-side) access."""

    def __init__(self, R, t, points, obs_inlier, chi2, pack, meta):
        self.R = R
        self.t = t
        self.chi2 = chi2
        self._points = points
        self._inl = obs_inlier
        self._pack = pack
        self._meta = meta

    @property
    def points(self):
        return np.asarray(self._points)[: self._meta["P_tot"]]

    @property
    def obs_inlier(self):
        meta = self._meta
        grid = np.asarray(self._inl).reshape(meta["order"].shape)
        out = np.zeros(self._pack["obs_cam"].shape[0], bool)
        ok = meta["oval"]
        out[meta["order"][ok]] = grid[ok]
        return out


class _RowView:
    """Per-keyframe row copies with the source's indexing interface."""

    def __init__(self, src, ids):
        self._d = {int(k): np.array(src[int(k)], copy=True) for k in ids}

    def __getitem__(self, k):
        return self._d[int(k)]


class _MapSnapshot:
    """Consistent copy of everything the Sim3 chain reads for two
    keyframes, taken under store.lock on the worker thread (ADVICE r3
    #1): the tracking thread keeps mutating kf/pt arrays in place, and
    a Sim3 fit on torn state can pass its inlier gates and rewrite the
    whole map with a wrong similarity."""

    def __init__(self, store, ids):
        for name in ("kf_desc", "kf_obs_lm", "kf_feat_valid", "kf_xy",
                     "kf_oct", "kf_R", "kf_t"):
            setattr(self, name, _RowView(getattr(store, name), ids))
        self.pt_pos = store.pt_pos.copy()
        self.pt_valid = store.pt_valid.copy()


@dataclasses.dataclass
class LoopEdge:
    kf_a: int
    kf_b: int
    s: float
    R: np.ndarray
    t: np.ndarray
    # Slot generations at creation: a culled+recycled slot is a
    # DIFFERENT keyframe — stale edges must not constrain it
    # (VERDICT r2 weak #3).
    gen_a: int = 0
    gen_b: int = 0


class LoopCloser:
    def __init__(self, cfg: SlamConfig, store: MapStore, voc: Vocabulary):
        self.cfg = cfg
        self.map = store
        self.voc = voc
        self.db = KeyFrameDatabase(voc)
        self.consistent_groups: list[tuple[set[int], int]] = []
        self.loop_edges: list[LoopEdge] = []
        # Temporal recency gate in PROCESSED-KEYFRAME counts (slot ids
        # are recycled and non-monotonic — ADVICE r2 #3).
        self.kf_counter = 0
        self.last_loop_count = -100
        self.last_closed_kf = -1
        self.covis_cache = None
        # Called right before a correction rewrites poses (wired by
        # System to drain the tracker's in-flight async mapping work).
        self.pre_correct_hook = None
        # One-keyframe BoW lag: the word transform for keyframe k is
        # dispatched when k arrives and resolved when k+1 arrives (the
        # fetch hides behind a full keyframe interval); detection then
        # runs for k — the reference's LoopClosing queue has the same
        # one-keyframe latency.
        self._pending_bow = None
        # Cull listener: drop dead keyframes from the inverted index and
        # the consistency state BEFORE their slot is recycled.
        store.on_kf_culled.append(self._on_kf_culled)
        # Asynchronous global BA (the reference's detached
        # RunGlobalBundleAdjustment thread + mbStopGBA interruption —
        # SURVEY.md §3.4): when gba_async is set, CorrectLoop dispatches
        # the jitted solve and returns; the result is applied at a later
        # poll_global_ba(), with spanning-chain propagation to keyframes
        # and landmarks created while the solve was in flight.  A new
        # loop closure while one is pending discards the stale solve
        # (map-version interruption instead of a stop flag).
        self.gba_async = False
        self._pending_gba = None
        # Which solver the last global BA was dispatched to ("dense",
        # "dense_lines", "cg" or "sharded_cg") and how many results were
        # written back: what a caller reads to confirm the route taken.
        self.gba_route = None
        self.n_gba_applied = 0
        # Monocular maps drift in scale, so the loop Sim3 must estimate
        # it (Sim3Solver's bFixScale=false); stereo/RGB-D pin s=1.
        # System sets this from the tracker's sensor type.
        self.fix_scale = True
        # --- asynchronous detection (the reference's LoopClosing
        # pthread, src/LoopClosing.cc Run loop — SURVEY.md §2.4): when
        # async_detect is set, process_keyframe enqueues the keyframe to
        # a host worker thread that runs BoW transform + candidate
        # detection + the full Sim3 chain (whose ~0.5 s of device
        # round-trips otherwise stall the frame loop at every attempt —
        # measured 121 ms/frame on the synthetic loop).  The worker
        # NEVER mutates the map: a successful detection parks
        # (kf, cand, Sim3) in _pending_loop and the map-rewriting
        # _correct runs on the tracking thread at the next keyframe
        # event (the reference pauses LocalMapping for CorrectLoop the
        # same way).  Generation stamps guard both ends against
        # cull+slot-recycling while the detection was in flight.
        self.async_detect = False
        self._jobs: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._pending_loop = None   # (kf, gen, cand, cand_gen, sim, count)
        self._db_lock = threading.Lock()
        self._worker_exc = None

    # ------------------------------------------------------------------
    def warmup_jit(self):
        """Pre-trace the Sim3 chain (match -> RANSAC -> guided refine ->
        optimize) with canonical shapes so the first real loop attempt
        doesn't pay ~4 s of host tracing mid-sequence."""
        store = self.map
        cam = self.cfg.camera
        F = store.F
        d = np.zeros((F, 32), np.uint8)
        v = np.zeros(F, bool)
        m = match_descriptors(
            jnp.asarray(d), jnp.asarray(v), jnp.asarray(d), jnp.asarray(v),
            max_dist=50, ratio=0.75,
        )
        N = 256
        solve_sim3_ransac(
            jnp.zeros((N, 3)), jnp.zeros((N, 3)), jnp.zeros(N, bool),
            jax.random.PRNGKey(0), cam, cam, jnp.ones(N), jnp.ones(N),
            fix_scale=self.fix_scale, n_hyps=256,
        )
        scales = self.cfg.orb.level_scales
        search_by_sim3_dir(
            jnp.zeros((F, 3)), jnp.asarray(d), jnp.asarray(v),
            jnp.zeros((F, 2)), jnp.asarray(d), jnp.zeros(F, jnp.int32),
            jnp.asarray(v), cam, scales,
        )
        M = 512
        optimize_sim3(
            jnp.float32(1.0), jnp.eye(3), jnp.zeros(3),
            jnp.zeros((M, 3)), jnp.zeros((M, 3)), jnp.zeros((M, 2)),
            jnp.zeros((M, 2)), jnp.ones(M), jnp.ones(M), jnp.zeros(M, bool),
            cam, cam, fix_scale=self.fix_scale,
        )
        self._warmup_correction_programs()
        jax.block_until_ready(m.idx)

    def _warmup_correction_programs(self):
        """Pre-compile the two big correction-path programs at their
        session-stable buckets: the Sim3 pose graph (Kpad = table
        capacity rounded to 32, E rounded to 256) and the full-map BA
        at the configured capacities.  Un-warmed, each costs 10-25 s of
        trace+compile ON the correction path (measured on chip — the
        dominant term of the mid-run fps dips)."""
        store = self.map
        mc = self.cfg.map
        cam = self.cfg.camera
        # The live path pads K to the full table capacity; warm exactly
        # that rung at the two typical edge-count rungs.
        Kpad = store.kf_R.shape[0]
        for Epad in (256, 512):
            optimize_pose_graph(
                jnp.ones(Kpad), jnp.tile(jnp.eye(3), (Kpad, 1, 1)),
                jnp.zeros((Kpad, 3)),
                jnp.zeros(Kpad, bool).at[:2].set(True),
                jnp.zeros(Kpad, bool).at[0].set(True),
                jnp.zeros(Epad, jnp.int32),
                jnp.ones(Epad, jnp.int32),
                jnp.ones(Epad), jnp.tile(jnp.eye(3), (Epad, 1, 1)),
                jnp.zeros((Epad, 3)),
                jnp.zeros(Epad, bool).at[0].set(True), jnp.ones(Epad),
                n_iters=20,
            )
        # Full-map BA at the exact _dispatch_gba bucket.  Mirror its
        # shape/threshold math; the line variant only when lines exist.
        n_cams = mc.max_keyframes
        n_pts = mc.max_points
        n_obs = n_cams * 1024
        if n_cams * n_pts * 18 * 4 <= 256 * 1024 * 1024:
            args = (
                jnp.tile(jnp.eye(3), (n_cams, 1, 1)), jnp.zeros((n_cams, 3)),
                jnp.zeros(n_cams, bool).at[0].set(True),
                jnp.ones((n_pts, 3)), jnp.ones(n_pts, bool),
                jnp.zeros(n_obs, jnp.int32), jnp.zeros(n_obs, jnp.int32),
                jnp.ones((n_obs, 3)), jnp.zeros(n_obs, jnp.int32),
                jnp.zeros(n_obs, bool),
            )
            # iters must match the correction path's static args
            # (run/dispatch_global_ba default 12+0).
            if store.Lf:
                from ..backend.line_ba import bundle_adjust_pl

                Lc = mc.max_lines
                Ol = Lc * 8
                bundle_adjust_pl(
                    *args[:10],
                    jnp.tile(jnp.eye(3), (Lc, 1, 1)),
                    jnp.tile(jnp.asarray([1.0, 0.1]), (Lc, 1)),
                    jnp.zeros(Lc, bool),
                    jnp.zeros(Ol, jnp.int32), jnp.zeros(Ol, jnp.int32),
                    jnp.ones((Ol, 2)), jnp.ones((Ol, 2)),
                    jnp.zeros(Ol, jnp.int32), jnp.zeros(Ol, bool),
                    cam, self.cfg.orb.scale_factor, iters1=12, iters2=0,
                )
            else:
                bundle_adjust(
                    *args, cam, self.cfg.orb.scale_factor,
                    iters1=12, iters2=0, fix_first=True,
                )

    # ------------------------------------------------------------------
    def _on_kf_culled(self, k: int, parent: int):
        with self._db_lock:
            self.db.erase(k)
            self.consistent_groups = [
                (g - {k}, c) for g, c in self.consistent_groups if g - {k}
            ]
        if self._pending_bow is not None and self._pending_bow[0] == k:
            self._pending_bow = None

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, run_gba: bool = True) -> bool:
        """Dispatch kf_id's BoW transform; detect + close a loop ending
        at the PREVIOUS keyframe (whose words are now resolved — the
        fetch hid behind one keyframe interval, and the reference's
        LoopClosing queue has the same one-keyframe latency).  Returns
        True if a loop was closed (map was rewritten);
        `last_closed_kf` then names the corrected keyframe."""
        store = self.map
        self.kf_counter += 1
        if self.async_detect:
            # Apply a parked correction from the worker (map mutation
            # stays on this thread), then hand the new keyframe to it.
            applied = self._apply_pending(run_gba)
            self._ensure_worker()
            self._jobs.put((kf_id, int(store.kf_gen[kf_id]), self.kf_counter))
            return applied
        valid = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] >= 0)
        prev = self._pending_bow
        self._pending_bow = (
            kf_id, int(store.kf_gen[kf_id]),
            self.voc.dispatch_transform(store.kf_desc[kf_id]), valid,
        )
        return self._process_resolved(prev, run_gba)

    # ------------------------------------------------------------------
    # async detection worker (the reference's LoopClosing thread)
    # ------------------------------------------------------------------
    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._jobs = queue.Queue()
            self._worker = threading.Thread(
                target=self._worker_loop, name="loop-closing", daemon=True
            )
            self._worker.start()

    def _worker_loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                self._detect_job(*job)
            except Exception as e:  # surfaced by flush()
                self._worker_exc = e
            finally:
                self._jobs.task_done()

    def _detect_job(self, kf_id: int, gen: int, count: int):
        """Worker-side: BoW transform + index insert + detection + Sim3.
        Read-only on the map; parks a hit in _pending_loop."""
        store = self.map
        if not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
            return
        valid = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] >= 0)
        words = np.asarray(self.voc.dispatch_transform(store.kf_desc[kf_id]))
        with self._db_lock:
            if not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
                return
            self.db.add_words(kf_id, words, valid)
        if (
            store.n_keyframes() < 6
            or count - self.last_loop_count < 10
            or self._pending_loop is not None
        ):
            return
        with store.lock, self._db_lock:
            cand = self._detect(kf_id)
        if cand is None or not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
            return
        with store.lock:
            cand_gen = int(store.kf_gen[cand])
            view = _MapSnapshot(store, (kf_id, cand))
        ok, sim = self._compute_sim3(kf_id, cand, view=view)
        if ok:
            self._pending_loop = (kf_id, gen, cand, cand_gen, sim, count)

    def _apply_pending(self, run_gba: bool) -> bool:
        """Tracking-thread side: apply a worker-detected loop (the
        map-rewriting CorrectLoop half)."""
        p = self._pending_loop
        if p is None:
            return False
        self._pending_loop = None
        kf_id, gen, cand, cand_gen, sim, _count = p
        store = self.map
        if (
            not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen
            or not store.kf_valid[cand] or store.kf_gen[cand] != cand_gen
        ):
            return False
        with store.lock:
            self._correct(kf_id, cand, sim, run_gba=run_gba)
        self.last_loop_count = self.kf_counter
        self.last_closed_kf = kf_id
        return True

    def stop(self):
        """Terminate the detection worker (sentinel + join).  Called
        from System.shutdown()/reset() so repeated construction doesn't
        accumulate idle daemon threads holding old maps alive
        (ADVICE r3 #4)."""
        if self._worker is not None and self._worker.is_alive():
            self._jobs.put(None)
            self._worker.join(timeout=30.0)
        self._worker = None

    def flush(self, run_gba: bool = True) -> bool:
        """Drain the pending keyframe's detection (shutdown / end of
        sequence)."""
        if self.async_detect:
            if self._jobs is not None:
                self._jobs.join()   # worker idle, queue drained
            if self._worker_exc is not None:
                # Apply a successfully parked loop BEFORE surfacing the
                # worker's exception — the detection succeeded.
                self._apply_pending(run_gba)
                exc, self._worker_exc = self._worker_exc, None
                raise exc
            return self._apply_pending(run_gba)
        prev = self._pending_bow
        self._pending_bow = None
        return self._process_resolved(prev, run_gba)

    def _process_resolved(self, prev, run_gba: bool) -> bool:
        store = self.map
        if prev is None:
            return False
        pkf, pgen, words_dev, pvalid = prev
        if not store.kf_valid[pkf] or store.kf_gen[pkf] != pgen:
            return False  # culled while in flight
        self.db.add_words(pkf, np.asarray(words_dev), pvalid)
        if (
            store.n_keyframes() < 6
            or self.kf_counter - self.last_loop_count < 10
        ):
            return False

        cand = self._detect(pkf)
        if cand is None:
            return False
        ok, sim = self._compute_sim3(pkf, cand)
        if not ok:
            return False
        self._correct(pkf, cand, sim, run_gba=run_gba)
        self.last_loop_count = self.kf_counter
        self.last_closed_kf = pkf
        return True

    # ------------------------------------------------------------------
    def _covisible_set(self, kf_id, min_w=15):
        W = self.map.covisibility()
        ids = np.nonzero(W[kf_id] >= min_w)[0]
        return set(int(i) for i in ids)

    def _detect(self, kf_id):
        """BoW candidates + consistency over 3 consecutive keyframes."""
        store = self.map
        covis = self._covisible_set(kf_id)
        # minScore: lowest BoW similarity among covisible KFs.
        min_score = 0.008
        scores = [
            self.db.score(kf_id, k) for k in covis if k in self.db.bow
        ]
        if scores:
            min_score = max(min(scores), 0.001)
        group_cache: dict[int, set] = {}

        def covis_group(k):
            if k not in group_cache:
                group_cache[k] = self._covisible_set(k) | {k}
            return group_cache[k]

        cands = self.db.detect_loop_candidates(
            kf_id, min_score, covis | {kf_id}, covis_group
        )
        if not cands:
            self.consistent_groups = []
            return None

        # Covisibility-consistency over 3 consecutive KFs
        # (LoopClosing::DetectLoop's mvConsistentGroups logic).
        new_groups = []
        winner = None
        for c in cands:
            group = covis_group(c)
            consistency = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistency = prev_count + 1
                    break
            new_groups.append((group, consistency))
            if consistency >= 2 and winner is None:
                winner = c
        self.consistent_groups = new_groups
        return winner

    # ------------------------------------------------------------------
    def _compute_sim3(self, kf_id, cand, view=None):
        """Match landmarks between the two keyframes, RANSAC a Sim3
        T_{cur<-cand} in camera frames.  `view` (worker thread) is a
        _MapSnapshot so every read sees one consistent map state."""
        store = view if view is not None else self.map
        cur_lm = store.kf_obs_lm[kf_id]
        cand_lm = store.kf_obs_lm[cand]
        v_cur = (cur_lm >= 0) & store.kf_feat_valid[kf_id]
        v_cand = (cand_lm >= 0) & store.kf_feat_valid[cand]
        m = match_descriptors(
            jnp.asarray(store.kf_desc[kf_id]), jnp.asarray(v_cur),
            jnp.asarray(store.kf_desc[cand]), jnp.asarray(v_cand),
            max_dist=50, ratio=0.75,
        )
        mask, idx = jax.device_get((m.mask, m.idx))  # one fetch round-trip
        if mask.sum() < 20:
            return False, None

        rows = np.nonzero(mask)[0]
        lm1 = cur_lm[rows]
        lm2 = cand_lm[idx[rows]]
        ok = (lm1 >= 0) & (lm2 >= 0) & store.pt_valid[lm1] & store.pt_valid[lm2]
        rows, lm1, lm2 = rows[ok], lm1[ok], lm2[ok]
        if len(rows) < 20:
            return False, None

        # 3D points in each camera frame (host math).
        R1, t1 = store.kf_R[kf_id], store.kf_t[kf_id]
        R2, t2 = store.kf_R[cand], store.kf_t[cand]
        p1 = nse3_apply(R1, t1, store.pt_pos[lm1])
        p2 = nse3_apply(R2, t2, store.pt_pos[lm2])

        N = 256
        pts1 = np.zeros((N, 3), np.float32)
        pts2 = np.zeros((N, 3), np.float32)
        valid = np.zeros(N, bool)
        n = min(len(p1), N)
        pts1[:n] = p1[:n]
        pts2[:n] = p2[:n]
        valid[:n] = True

        s, R, t, inl, count = jax.device_get(
            solve_sim3_ransac(
                jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid),
                jax.random.PRNGKey(kf_id), self.cfg.camera, self.cfg.camera,
                jnp.ones(N), jnp.ones(N), fix_scale=self.fix_scale,
                n_hyps=256,
            )
        )
        if int(count) < 20:
            return False, None

        # --- guided SearchBySim3 + OptimizeSim3 (ComputeSim3's second
        # half, §3.4): grow the match set by projecting each keyframe's
        # landmarks into the other with the RANSAC Sim3, then refine the
        # 7-DoF (mono) / 6-DoF (stereo) estimate with bidirectional
        # reprojection GN and a chi2=10 gate.  Only RANSAC INLIER
        # matches seed the refinement (the reference keeps only
        # vbInliers of vpMatches12 before SearchBySim3).
        keep = np.zeros(len(rows), bool)
        keep[:n] = np.asarray(inl)[:n]
        refined = self._refine_sim3(
            kf_id, cand, float(s), R, t, rows[keep], lm1[keep], lm2[keep],
            view=view,
        )
        if refined is None:
            return False, None
        return True, refined

    # ------------------------------------------------------------------
    def _refine_sim3(self, kf_id, cand, s, R, t, rows_bow, lm1_bow, lm2_bow,
                     view=None):
        """SearchBySim3 (mutual guided matching) + optimize_sim3.
        Returns the refined (s, R, t) of T_{cur<-cand} or None if fewer
        than 20 inliers survive (the reference's acceptance bar)."""
        store = view if view is not None else self.map
        cam = self.cfg.camera
        scales = self.cfg.orb.level_scales

        R1, t1 = store.kf_R[kf_id], store.kf_t[kf_id]
        R2, t2 = store.kf_R[cand], store.kf_t[cand]
        lm_cur = store.kf_obs_lm[kf_id]
        lm_cand = store.kf_obs_lm[cand]
        m_cur = (
            store.kf_feat_valid[kf_id] & (lm_cur >= 0)
            & store.pt_valid[np.clip(lm_cur, 0, None)]
        )
        m_cand = (
            store.kf_feat_valid[cand] & (lm_cand >= 0)
            & store.pt_valid[np.clip(lm_cand, 0, None)]
        )
        # Landmarks in each keyframe's own camera frame.
        p_cur = nse3_apply(R1, t1, store.pt_pos[np.clip(lm_cur, 0, None)])
        p_cand = nse3_apply(R2, t2, store.pt_pos[np.clip(lm_cand, 0, None)])
        # cand landmarks into cur's frame via S12; cur's into cand via S21.
        si, Ri, ti = nsim3_inverse(s, R, t)
        p_cand_in_cur = nsim3_apply(s, R, t, p_cand)
        p_cur_in_cand = nsim3_apply(si, Ri, ti, p_cur)

        mA = search_by_sim3_dir(
            jnp.asarray(p_cand_in_cur), jnp.asarray(store.kf_desc[cand]),
            jnp.asarray(m_cand), jnp.asarray(store.kf_xy[kf_id]),
            jnp.asarray(store.kf_desc[kf_id]),
            jnp.asarray(store.kf_oct[kf_id]),
            jnp.asarray(m_cur), cam, scales,
        )
        mB = search_by_sim3_dir(
            jnp.asarray(p_cur_in_cand), jnp.asarray(store.kf_desc[kf_id]),
            jnp.asarray(m_cur), jnp.asarray(store.kf_xy[cand]),
            jnp.asarray(store.kf_desc[cand]),
            jnp.asarray(store.kf_oct[cand]),
            jnp.asarray(m_cand), cam, scales,
        )
        # One fetch for both guided searches (each np.asarray would be
        # its own device round-trip).
        idxA, idxB, maskA = jax.device_get((mA.idx, mB.idx, mA.mask))
        cand_rows = np.nonzero(maskA)[0]
        cur_of = idxA[cand_rows]
        mutual = (cur_of >= 0) & (idxB[np.clip(cur_of, 0, None)] == cand_rows)
        pairs_cur = cur_of[mutual]
        pairs_cand = cand_rows[mutual]

        # Union with the BoW/RANSAC matches (cur row, cand landmark) —
        # keyed by cur feature row to avoid duplicates.
        cand_row_of_lm = np.full(store.pt_pos.shape[0], -1, np.int64)
        cand_row_of_lm[lm_cand[m_cand]] = np.nonzero(m_cand)[0]
        seen = set(pairs_cur.tolist())
        add_cur, add_cand = [], []
        for r_cur, l2 in zip(rows_bow, lm2_bow):
            rc = cand_row_of_lm[l2]
            if rc >= 0 and int(r_cur) not in seen:
                add_cur.append(int(r_cur))
                add_cand.append(int(rc))
                seen.add(int(r_cur))
        all_cur = np.concatenate([pairs_cur, np.asarray(add_cur, np.int64)])
        all_cand = np.concatenate([pairs_cand, np.asarray(add_cand, np.int64)])
        if len(all_cur) < 20:
            return None

        N = 512
        n = min(len(all_cur), N)
        pts1 = np.zeros((N, 3), np.float32)
        pts2 = np.zeros((N, 3), np.float32)
        obs1 = np.zeros((N, 2), np.float32)
        obs2 = np.zeros((N, 2), np.float32)
        s2_1 = np.ones(N, np.float32)
        s2_2 = np.ones(N, np.float32)
        valid = np.zeros(N, bool)
        sc = np.asarray(scales, np.float32)
        pts1[:n] = p_cur[all_cur[:n]]
        pts2[:n] = p_cand[all_cand[:n]]
        obs1[:n] = store.kf_xy[kf_id][all_cur[:n]]
        obs2[:n] = store.kf_xy[cand][all_cand[:n]]
        s2_1[:n] = sc[np.clip(store.kf_oct[kf_id][all_cur[:n]], 0, len(sc) - 1)] ** 2
        s2_2[:n] = sc[np.clip(store.kf_oct[cand][all_cand[:n]], 0, len(sc) - 1)] ** 2
        valid[:n] = True

        res = optimize_sim3(
            jnp.float32(s), jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32),
            jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(obs1),
            jnp.asarray(obs2), jnp.asarray(s2_1), jnp.asarray(s2_2),
            jnp.asarray(valid), cam, cam, fix_scale=self.fix_scale,
        )
        n_inl = int(res.n_inliers)
        if n_inl < 20:
            return None
        return float(res.s), np.asarray(res.R), np.asarray(res.t)

    # ------------------------------------------------------------------
    def _correct(self, kf_id, cand, sim, run_gba=True):
        """Propagate the Sim3 correction, fuse, optimize the essential
        graph, optionally run global BA."""
        # Land in-flight async mapping work FIRST (the reference pauses
        # LocalMapping and drains its queue before CorrectLoop): solves
        # and searches dispatched against pre-correction poses would
        # otherwise be discarded by the pose-epoch guard, losing their
        # observations from the about-to-be-corrected map.
        if self.pre_correct_hook is not None:
            self.pre_correct_hook()
        store = self.map
        s_lc, R_lc, t_lc = sim  # T_cur<-cand (camera frames)

        # Corrected pose of current KF: Scw_corr = S_cur<-cand ∘ Tcand_w
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        s_corr, R_corr, t_corr = nsim3_compose(s_lc, R_lc, t_lc, 1.0, Rc, tc)

        # World-side correction for the current covisible group: the
        # current KF moves from its drifted Tcw to the corrected Sim3;
        # x_cam = T_old x_w ; x_w_new = S_corr^-1 x_cam  (all host math —
        # this loop used to dispatch one device op per landmark).
        R_old, t_old = store.kf_R[kf_id].copy(), store.kf_t[kf_id].copy()
        # Pre-correction pose snapshot for the essential graph's edge
        # measurements (the reference's NonCorrectedSim3): tree/covis
        # edges must be measured from the DRIFTED poses — measuring a
        # boundary edge after the group rewrite bakes the correction
        # discontinuity into the measurement and the graph optimizes to
        # a no-op (measured exactly that before this fix).
        pre_R = store.kf_R.copy()
        pre_t = store.kf_t.copy()
        group = self._covisible_set(kf_id, min_w=10) | {kf_id}
        s_ci, R_ci, t_ci = nsim3_inverse(s_corr, R_corr, t_corr)

        lm_ids = np.unique(
            np.concatenate(
                [store.kf_obs_lm[k][store.kf_obs_lm[k] >= 0] for k in group]
            ).astype(np.int64)
        ) if group else np.array([], np.int64)
        lm_ids = lm_ids[store.pt_valid[lm_ids]] if len(lm_ids) else lm_ids
        if len(lm_ids):
            x_cam = nse3_apply(R_old, t_old, store.pt_pos[lm_ids])
            store.pt_pos[lm_ids] = nsim3_apply(s_ci, R_ci, t_ci, x_cam)
        # Line landmarks of the group move with the same correction.
        kf_ln_obs = getattr(store, "kf_ln_obs", None)
        if kf_ln_obs is not None:
            ln_ids = np.unique(
                np.concatenate(
                    [kf_ln_obs[k][kf_ln_obs[k] >= 0] for k in group]
                ).astype(np.int64)
            )
            ln_ids = ln_ids[store.ln_valid[ln_ids]] if len(ln_ids) else ln_ids
            for attr in ("ln_start", "ln_end"):
                if not len(ln_ids):
                    break
                arr = getattr(store, attr)
                arr[ln_ids] = nsim3_apply(
                    s_ci, R_ci, t_ci, nse3_apply(R_old, t_old, arr[ln_ids])
                )
        # poses: Tkw_new = Tk_old ∘ T_old^-1 ∘ S_corr
        Roi, toi = nse3_inverse(R_old, t_old)
        for k in group:
            Rrel, trel = nse3_compose(store.kf_R[k], store.kf_t[k], Roi, toi)
            sk, Rk2, tk2 = nsim3_compose(1.0, Rrel, trel, s_corr, R_corr, t_corr)
            store.kf_R[k] = Rk2
            store.kf_t[k] = tk2 / sk  # renormalize scale into t

        store.mark_all_pts_dirty()

        # --- SearchAndFuse (LoopClosing::SearchAndFuse): project the
        # loop side's landmarks into the corrected current-group
        # keyframes and merge duplicates.  This is what puts the loop
        # constraint INTO the bundle-adjustment problem — without
        # shared observations across the loop, global BA is an
        # open-chain problem that happily re-introduces the drift the
        # essential graph just removed (measured: GBA max error
        # 0.96 -> 4.9 m without this step).
        from ..slam_map.fuse import fuse_into_keyframe

        # Covisibility snapshot BEFORE fuse: edges that exist only
        # because of the fusion below are cross-loop "LoopConnections"
        # and must be measured from CORRECTED poses in the essential
        # graph (the reference's LoopConnections argument); measuring
        # them from the drifted pre-poses bakes the loop discontinuity
        # into those measurements and the graph fights its own loop
        # edge (measured: EG degraded mean KF error 0.23 -> 0.61 m).
        W_pre = self.map.covisibility().copy()
        cand_group = self._covisible_set(cand, min_w=5) | {cand}
        loop_lm = np.unique(
            np.concatenate(
                [store.kf_obs_lm[k][store.kf_obs_lm[k] >= 0] for k in cand_group]
            ).astype(np.int64)
        )
        loop_lm = loop_lm[store.pt_valid[loop_lm]]
        if len(loop_lm):
            scales = self.cfg.orb.level_scales
            for k in group:
                fuse_into_keyframe(
                    store, loop_lm, k, self.cfg.camera, scales, radius=4.0
                )

        # Record the loop edge (measurement = corrected relative pose).
        self.loop_edges.append(
            LoopEdge(
                kf_id, cand, s_lc, np.asarray(R_lc), np.asarray(t_lc),
                gen_a=int(store.kf_gen[kf_id]), gen_b=int(store.kf_gen[cand]),
            )
        )

        # --- essential-graph optimization over all valid KFs ---
        self._optimize_essential_graph(
            kf_id, cand, pre_R=pre_R, pre_t=pre_t, W_pre=W_pre
        )

        if run_gba:
            if self.gba_async:
                # A newer loop supersedes any in-flight global BA
                # (mbStopGBA): the stale solve is simply never applied.
                self._pending_gba = None
                self.dispatch_global_ba()
            else:
                self.run_global_ba()

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, cur_kf, loop_kf, pre_R=None,
                                  pre_t=None, W_pre=None):
        """Sim3 pose graph over the essential graph: parent-child
        SPANNING TREE + strong covisibility (>=100 shared landmarks) +
        validated loop edges — the reference's OptimizeEssentialGraph
        edge set ([E] src/Optimizer.cc; SURVEY.md §3.4).  Slot ids carry
        no temporal meaning (recycling), so tree fallbacks order by
        kf_frame_id, never by slot index."""
        store = self.map
        Kn = store._next_kf
        valid = store.kf_valid[:Kn].copy()
        ids = np.nonzero(valid)[0]
        if len(ids) < 3:
            return
        W = store.covisibility()

        edges_i, edges_j, ew = [], [], []
        # Spanning-tree edges: each keyframe to its parent.  Orphans
        # (parent culled before reparenting existed, or roots of later
        # sessions) chain to the temporally previous keyframe so the
        # graph stays connected.
        order = ids[np.argsort(store.kf_frame_id[ids], kind="stable")]
        pos_in_order = {int(k): i for i, k in enumerate(order)}
        for b in ids:
            a = int(store.kf_parent[b])
            if a < 0 or a == b or not (0 <= a < Kn) or not valid[a]:
                i = pos_in_order[int(b)]
                if i == 0:
                    continue  # the temporal root has no parent edge
                a = int(order[i - 1])
            edges_i.append(a)
            edges_j.append(int(b))
            ew.append(1.0)
        n_tree = len(edges_i)
        # strong covisibility edges (vectorized; dedup against the tree)
        tree = set(zip(edges_i, edges_j))
        sub = W[np.ix_(ids, ids)] >= 100
        ai, bi = np.nonzero(np.triu(sub, k=1))
        for a, b in zip(ids[ai], ids[bi]):
            a, b = int(a), int(b)
            if (a, b) not in tree and (b, a) not in tree:
                edges_i.append(a)
                edges_j.append(b)
                ew.append(1.0)
        # Loop edges, generation-validated: an edge whose endpoint slot
        # was recycled would constrain an unrelated keyframe.
        live_edges = [
            e for e in self.loop_edges
            if 0 <= e.kf_a < Kn and 0 <= e.kf_b < Kn
            and valid[e.kf_a] and valid[e.kf_b]
            and store.kf_gen[e.kf_a] == e.gen_a
            and store.kf_gen[e.kf_b] == e.gen_b
        ]
        for e in live_edges:
            edges_i.append(e.kf_b)
            edges_j.append(e.kf_a)
            ew.append(1.0)

        E = len(edges_i)
        es = np.ones(E, np.float32)
        eR = np.zeros((E, 3, 3), np.float32)
        et = np.zeros((E, 3), np.float32)
        n_loop = len(live_edges)
        for n, (a, b) in enumerate(zip(edges_i, edges_j)):
            if n >= E - n_loop:
                le = live_edges[n - (E - n_loop)]
                eR[n] = le.R
                et[n] = le.t
                es[n] = le.s
                continue
            # Measurements from the PRE-correction poses when given
            # (NonCorrectedSim3); within the corrected group the rigid
            # rewrite preserves relatives, so only boundary edges differ.
            # Covisibility edges NEW since the loop fuse (cross-loop
            # LoopConnections) measure from the CORRECTED poses instead.
            mR = store.kf_R if pre_R is None else pre_R
            mt = store.kf_t if pre_t is None else pre_t
            if (
                W_pre is not None
                and a < W_pre.shape[0] and b < W_pre.shape[0]
                and W_pre[a, b] < 100
                and n >= n_tree
            ):
                mR, mt = store.kf_R, store.kf_t
            Rm, tm = nse3_relative(mR[b], mt[b], mR[a], mt[a])
            eR[n] = Rm
            et[n] = tm

        # Stable jit buckets: Kn and the edge count change with every
        # correction, and unbucketed they force a full XLA recompile of
        # the pose-graph program per loop closure (~6-9 s measured on
        # chip — the dominant term of the mid-run fps dips).  Pad K to
        # the full TABLE CAPACITY (rows past _next_kf are invalid
        # slots, and the capacity rung is the one warmup_jit
        # pre-compiles) and the edge set to a multiple of 256 with
        # masked-out edges.
        Kpad = store.kf_R.shape[0]
        valid = store.kf_valid[:Kpad].copy()
        Epad = -(-E // 256) * 256
        pad = Epad - E
        if pad:
            edges_i = edges_i + [0] * pad
            edges_j = edges_j + [0] * pad
            ew = ew + [0.0] * pad
            es = np.concatenate([es, np.ones(pad, np.float32)])
            eR = np.concatenate(
                [eR, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))]
            )
            et = np.concatenate([et, np.zeros((pad, 3), np.float32)])
        e_valid = np.zeros(Epad, bool)
        e_valid[:E] = True
        s0 = np.ones(Kpad, np.float32)
        fixed = np.zeros(Kpad, bool)
        fixed[loop_kf] = True
        fixed[~valid] = True
        old_R = store.kf_R[:Kpad].copy()
        old_t = store.kf_t[:Kpad].copy()

        s, R, t = jax.device_get(
            optimize_pose_graph(
                jnp.asarray(s0), jnp.asarray(store.kf_R[:Kpad]),
                jnp.asarray(store.kf_t[:Kpad]),
                jnp.asarray(valid), jnp.asarray(fixed),
                jnp.asarray(np.array(edges_i, np.int32)),
                jnp.asarray(np.array(edges_j, np.int32)),
                jnp.asarray(es), jnp.asarray(eR), jnp.asarray(et),
                jnp.asarray(e_valid), jnp.asarray(np.array(ew, np.float32)),
                n_iters=20,
            )
        )

        # Correct landmarks via their reference keyframe's motion
        # (landmark correction step of CorrectLoop/OptimizeEssentialGraph),
        # ONE batched einsum over all landmarks (the per-group Python
        # loop was O(K) host dispatches — VERDICT r2 weak #5).
        pt_ids = np.nonzero(store.pt_valid)[0]
        fk = store.pt_first_kf[pt_ids]
        ok = (fk >= 0) & (fk < Kpad) & valid[np.clip(fk, 0, Kpad - 1)]
        pt_ids, fk = pt_ids[ok], fk[ok]
        if len(pt_ids):
            x_cam = (
                np.einsum("pij,pj->pi", old_R[fk], store.pt_pos[pt_ids])
                + old_t[fk]
            )
            t_new = t[fk] / s[fk][:, None]
            store.pt_pos[pt_ids] = np.einsum(
                "pi,pij->pj", x_cam - t_new, R[fk]
            ).astype(np.float32)
        # Line endpoints ride their first keyframe's motion likewise.
        ln_ids = np.nonzero(store.ln_valid)[0]
        lfk = store.ln_first_kf[ln_ids]
        ok = (lfk >= 0) & (lfk < Kpad) & valid[np.clip(lfk, 0, Kpad - 1)]
        ln_ids, lfk = ln_ids[ok], lfk[ok]
        if len(ln_ids):
            t_new = t[lfk] / s[lfk][:, None]
            for attr in ("ln_start", "ln_end"):
                arr = getattr(store, attr)
                x_cam = (
                    np.einsum("pij,pj->pi", old_R[lfk], arr[ln_ids])
                    + old_t[lfk]
                )
                arr[ln_ids] = np.einsum(
                    "pi,pij->pj", x_cam - t_new, R[lfk]
                ).astype(np.float32)

        store.kf_R[:Kpad] = R
        store.kf_t[:Kpad] = t / s[:, None]
        store.mark_all_pts_dirty()

    # ------------------------------------------------------------------
    def run_global_ba(self, iters1: int = 12, iters2: int = 0):
        """Full-map bundle adjustment, synchronous.  Like the
        reference's loop-closure GlobalBundleAdjustemnt this is a
        SINGLE robust stage (Huber throughout, no mid-way chi2 erasure):
        the post-loop map has honest large residuals in the drifted
        region, and the local-BA two-stage gate was measured to strip
        low-support keyframes bare there and let them diverge (per-cam
        error 3 -> 17 m).  Outlier observations are NOT erased at
        apply for the same reason."""
        out = self._dispatch_gba(iters1, iters2)
        if out is None:
            return
        pack, res = out
        self._apply_gba(pack, res, snap_valid=self.map.kf_valid.copy())

    def dispatch_global_ba(self, iters1: int = 12, iters2: int = 0):
        """Dispatch global BA without blocking (JAX async dispatch runs
        the solve on-device while tracking continues); apply later via
        poll_global_ba()."""
        out = self._dispatch_gba(iters1, iters2)
        if out is None:
            return
        pack, res = out
        self._pending_gba = (pack, res, self.map.kf_valid.copy())

    def poll_global_ba(self, force: bool = False) -> bool:
        """Apply a pending global-BA result if it has finished on device
        (or unconditionally with force=True).  Returns True if applied."""
        if self._pending_gba is None:
            return False
        pack, res, snap_valid = self._pending_gba
        if not force:
            ready = getattr(res.R, "is_ready", None)
            if ready is not None and not ready():
                return False
        self._pending_gba = None
        self._apply_gba(pack, res, snap_valid)
        return True

    def _apply_gba(self, pack, res, snap_valid: np.ndarray):
        """Write back the GBA solution; keyframes/landmarks created
        after the snapshot (while the solve was in flight) are corrected
        through the spanning chain / their reference keyframe's motion —
        the reference's post-GBA propagation in
        RunGlobalBundleAdjustment (SURVEY.md §3.4)."""
        store = self.map
        self.n_gba_applied += 1
        Kn = store._next_kf
        if snap_valid.shape[0] < Kn:  # keyframe axis grew mid-solve
            snap_valid = np.pad(snap_valid, (0, Kn - snap_valid.shape[0]))
        old_R = store.kf_R[:Kn].copy()
        old_t = store.kf_t[:Kn].copy()
        store.apply_ba_result(pack, res, erase_outliers=False)
        # Keyframes created during the solve (valid now, not at the
        # snapshot — ids may be recycled slots): T_k_new = (T_k_old ∘
        # T_p_old^-1) ∘ T_p_new with p the spanning-tree parent (falls
        # back to the nearest live earlier KF).
        fresh = np.nonzero(
            store.kf_valid[:Kn] & ~snap_valid[:Kn]
        )[0]
        solved = np.nonzero(store.kf_valid[:Kn] & snap_valid[:Kn])[0]
        solved_fids = store.kf_frame_id[solved]
        for k in fresh:
            p = int(store.kf_parent[k])
            if p < 0 or not store.kf_valid[p] or snap_valid.shape[0] <= p or not snap_valid[p]:
                # Temporally previous SOLVED keyframe (slot order is
                # meaningless under recycling — order by frame id).
                earlier = solved[solved_fids < store.kf_frame_id[k]]
                if len(earlier) == 0:
                    continue
                p = int(earlier[np.argmax(store.kf_frame_id[earlier])])
            R_rel = old_R[k] @ old_R[p].T
            t_rel = old_t[k] - R_rel @ old_t[p]
            store.kf_R[k] = (R_rel @ store.kf_R[p]).astype(np.float32)
            store.kf_t[k] = (R_rel @ store.kf_t[p] + t_rel).astype(np.float32)
        # Joint point+line solves carry optimized line geometry.
        lpack = pack.get("_lpack")
        skip_lines = None
        if lpack is not None and hasattr(res, "line_U"):
            store.apply_line_ba_result(
                lpack, np.asarray(res.line_U), np.asarray(res.line_w),
                np.asarray(res.lobs_inlier),
            )
            skip_lines = np.zeros(store.L, bool)
            skip_lines[lpack["ln_ids"]] = True
        # Landmarks outside the solved problem ride their first KF.
        in_pack = np.zeros(store.P, bool)
        in_pack[pack["lm_ids"]] = True
        self._ride_first_kf(
            old_R, old_t, Kn, skip_points=in_pack, skip_lines=skip_lines
        )
        store.mark_all_pts_dirty()

    def _ride_first_kf(self, old_R, old_t, Kn, skip_points=None,
                       skip_lines=None):
        """Re-anchor landmarks to their first keyframe's corrected pose:
        x_new = T_fk_new^-1 (T_fk_old x_old).  Applied to points (unless
        masked) and to ALL line endpoints (lines are not variables in
        the point-only global problems).  ONE batched einsum per array —
        the previous per-landmark Python loop was O(P) host work on the
        loop-closure path (VERDICT r2 weak #5)."""
        store = self.map

        def ride(arr, ids, fk):
            x_cam = np.einsum("pij,pj->pi", old_R[fk], arr[ids]) + old_t[fk]
            # R^T (x - t) per row
            arr[ids] = np.einsum(
                "pji,pj->pi", store.kf_R[fk], x_cam - store.kf_t[fk]
            ).astype(np.float32)

        pt_ids = np.nonzero(store.pt_valid)[0]
        if skip_points is not None:
            pt_ids = pt_ids[~skip_points[pt_ids]]
        fk = store.pt_first_kf[pt_ids]
        ok = (fk >= 0) & (fk < Kn) & store.kf_valid[np.clip(fk, 0, Kn - 1)]
        if ok.any():
            ride(store.pt_pos, pt_ids[ok], fk[ok])

        ln_ids = np.nonzero(store.ln_valid)[0]
        if skip_lines is not None:
            ln_ids = ln_ids[~skip_lines[ln_ids]]
        lfk = store.ln_first_kf[ln_ids]
        ok = (lfk >= 0) & (lfk < Kn) & store.kf_valid[np.clip(lfk, 0, Kn - 1)]
        if ok.any():
            ride(store.ln_start, ln_ids[ok], lfk[ok])
            ride(store.ln_end, ln_ids[ok], lfk[ok])

    def _dispatch_gba(self, iters1: int = 5, iters2: int = 10):
        """Build + dispatch the full-map BA problem; returns (pack, res)
        with res still in flight (JAX async dispatch).

        Small maps use the dense-block Schur kernel; past the point
        where its B [P,C,6,3] coupling tensor gets expensive (~128 MB)
        it switches to matrix-free CG on the Schur complement
        (backend/global_ba.py), so the full map is optimized with no
        landmark/observation truncation."""
        store = self.map
        Kn = store._next_kf
        ids = np.nonzero(store.kf_valid[:Kn])[0]
        if len(ids) < 2:
            return
        mc = self.cfg.map
        # ONE session-stable problem bucket: shapes derived from the
        # live KF/point counts changed with every correction, and each
        # new (C, P, O) combo re-traced + re-compiled the full-map BA
        # program for 10-25 s ON THE CORRECTION PATH (measured on chip
        # — the dominant term of the mid-run fps dips).  Padding
        # straight to the configured capacities costs only solve time
        # (0.65 s at C=96/P=12k/O=98k, and the solve is async anyway)
        # and lets warmup_jit pre-compile the exact program once.
        # The KF table can outgrow max_keyframes under culling pressure;
        # bucket that rare case by 32 rows.
        n_cams = max(mc.max_keyframes, -(-len(ids) // 32) * 32)
        n_pts = mc.max_points
        n_obs = n_cams * 1024
        dense_bytes = n_cams * n_pts * 18 * 4
        # 256 MB keeps the 128-KF/16k-point capacity config on the
        # dense+lines path (coupling tensor 151 MB, ~50 ms/LM-iter on
        # chip, solved asynchronously); CG takes over past that.
        use_cg = dense_bytes > 256 * 1024 * 1024
        pack = store.pack_local_ba(
            int(ids[-1]),
            max_cams=n_cams,
            max_points=n_pts,
            max_obs=n_obs,
            all_free=True,
        )
        # Multi-device: landmark-sharded CG-Schur over the full mesh
        # (psum-reduced camera system — SURVEY.md §2.4, BASELINE.json:5/11).
        n_dev = jax.device_count()
        if n_dev > 1 and use_cg:
            self.gba_route = "sharded_cg"
            return pack, self._dispatch_gba_sharded(pack, n_dev, iters1, iters2)
        args = (
            jnp.asarray(pack["R"]), jnp.asarray(pack["t"]),
            jnp.asarray(pack["cam_fixed"]),
            jnp.asarray(pack["points"]), jnp.asarray(pack["point_valid"]),
            jnp.asarray(pack["obs_cam"]), jnp.asarray(pack["obs_lm"]),
            jnp.asarray(pack["obs_uvur"]), jnp.asarray(pack["obs_oct"]),
            jnp.asarray(pack["obs_valid"]), self.cfg.camera,
        )
        if use_cg:
            from ..backend.global_ba import bundle_adjust_cg

            self.gba_route = "cg"
            res = bundle_adjust_cg(
                *args, self.cfg.orb.scale_factor,
                iters1=iters1, iters2=iters2, fix_first=True,
                cg_iters=min(6 * n_cams, 64),
            )
            return pack, res
        # Dense path: when the map carries line landmarks, global BA
        # optimizes them jointly (the reference's GlobalBundleAdjustemnt
        # includes MapLine vertices — arXiv:1711.08654 §III-C); the CG
        # path still rides lines on their first keyframe's motion.
        lpack = None
        if store.Lf and bool(store.ln_valid.any()):
            lpack = store.pack_line_obs(
                pack["cam_ids"], max_lines=self.cfg.map.max_lines,
                max_lobs=self.cfg.map.max_lines * 8,
            )
        if lpack is not None:
            from ..backend.line_ba import bundle_adjust_pl
            from ..geometry.host import (
                northonormal_from_pluecker,
                npluecker_from_endpoints,
            )

            ids_l = lpack["ln_ids"]
            Lc = self.cfg.map.max_lines
            s_w = np.zeros((Lc, 3), np.float32)
            e_w = np.ones((Lc, 3), np.float32)
            lval = np.zeros(Lc, bool)
            s_w[: len(ids_l)] = store.ln_start[ids_l]
            e_w[: len(ids_l)] = store.ln_end[ids_l]
            lval[: len(ids_l)] = True
            U0, w0 = northonormal_from_pluecker(
                *npluecker_from_endpoints(s_w, e_w)
            )
            fixed0 = np.asarray(pack["cam_fixed"]).copy()
            fixed0[0] = True
            res = bundle_adjust_pl(
                args[0], args[1], jnp.asarray(fixed0),
                *args[3:10],
                jnp.asarray(U0), jnp.asarray(w0), jnp.asarray(lval),
                jnp.asarray(lpack["lobs_cam"]), jnp.asarray(lpack["lobs_ln"]),
                jnp.asarray(lpack["lobs_a"]), jnp.asarray(lpack["lobs_b"]),
                jnp.zeros(len(lpack["lobs_cam"]), jnp.int32),
                jnp.asarray(lpack["lobs_valid"]),
                self.cfg.camera, self.cfg.orb.scale_factor,
                iters1=iters1, iters2=iters2,
            )
            pack["_lpack"] = lpack
            self.gba_route = "dense_lines"
            return pack, res
        self.gba_route = "dense"
        res = bundle_adjust(
            *args, self.cfg.orb.scale_factor,
            iters1=iters1, iters2=iters2, fix_first=True,
        )
        return pack, res

    def _dispatch_gba_sharded(self, pack, n_dev: int, iters1: int, iters2: int):
        """Dispatch global BA on the landmark-sharded distributed solver;
        returns a BAResult-compatible view whose obs_inlier is remapped
        from shard-grouped order back to pack order lazily at apply."""
        from jax.sharding import Mesh

        from ..parallel.sharded_ba import make_distributed_ba_cg, shard_gba_pack

        mesh = Mesh(np.array(jax.devices()), ("dp",))
        args, meta = shard_gba_pack(pack, n_dev)
        C = pack["R"].shape[0]
        ba = make_distributed_ba_cg(
            mesh, self.cfg.camera, scale_factor=self.cfg.orb.scale_factor,
            iters1=iters1, iters2=iters2, cg_iters=min(6 * C, 64),
        )
        # fix_first: gauge (pack_local_ba all_free keeps every KF free).
        cam_fixed = np.asarray(pack["cam_fixed"]).copy()
        cam_fixed[0 if not cam_fixed.any() else np.argmax(cam_fixed)] = True
        R, t, pts, inl, chi2 = ba(
            args[0], args[1], jnp.asarray(cam_fixed), *args[3:]
        )
        return _ShardedGBAResult(R, t, pts, inl, chi2, pack, meta)
