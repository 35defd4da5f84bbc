"""System facade — the embedder-facing API.

Rebuilds src/System.cc / include/System.h (SURVEY.md §1 L4): construct
with settings (+ optional vocabulary), feed frames with
track_stereo/track_rgbd, control localization mode / reset / shutdown,
save trajectories in TUM and KITTI formats (including the
relative-to-refKF replay of §3.5).

Differences by design: the reference spawns LocalMapping/LoopClosing
threads; here mapping runs inline per keyframe (device programs) and
loop closing is invoked per keyframe on the host.  A vocabulary may be
loaded from DBoW2's ORBvoc.txt, passed in, or — unlike the reference —
trained on the fly from the first keyframe's descriptors.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import SlamConfig, load_settings
from ..eval.trajectory import save_trajectory_kitti, save_trajectory_tum
from ..loop.loop_closing import LoopCloser
from ..loop.vocabulary import Vocabulary
from .tracking import Tracker


class System:
    def __init__(
        self,
        settings: SlamConfig | str | Path,
        vocabulary: Vocabulary | str | Path | None = None,
        use_loop_closing: bool = True,
        async_loop: bool = True,
    ):
        self.cfg = (
            settings if isinstance(settings, SlamConfig) else load_settings(settings)
        )
        self.tracker = Tracker(self.cfg)
        # pipeline_depth (consume lag): the host fetches frame k-2's
        # result while k-1 and k run on the device, hiding the per-frame
        # fetch behind two frames of compute.  Its worth on the GPU is
        # not measured yet (ROADMAP S3).
        self.tracker.pipeline_depth = 2
        self.voc: Optional[Vocabulary] = None
        if isinstance(vocabulary, Vocabulary):
            self.voc = vocabulary
        elif vocabulary is not None:
            self.voc = Vocabulary.parse_orbvoc_txt(vocabulary)
        self.use_loop_closing = use_loop_closing
        # Loop detection + Sim3 on a host worker thread (the reference's
        # LoopClosing pthread); corrections apply at keyframe events on
        # the tracking thread.  Disable for bit-deterministic runs (the
        # bench ATE path does).
        self.async_loop = async_loop
        self.loop_closer: Optional[LoopCloser] = None
        self.localization_only = False
        self.n_loops_closed = 0
        # Global BA runs asynchronously by default: dispatched at loop
        # closure, applied when the device solve finishes (checked per
        # keyframe) — the reference's detached GBA thread.
        self.gba_async = True
        self.tracker.on_keyframe = self._on_keyframe
        self._warmup_started = False
        self._warmup_threads: list[threading.Thread] = []
        self.warmup_errors: list[BaseException] = []

    # ------------------------------------------------------------------
    def warmup(self, block: bool = False):
        """Pre-compile every steady-state device program the pipeline
        can hit mid-sequence: the local-BA (P, O) bucket ladder, the
        mirror delta-bucket ladder, and (once it exists) the loop
        closer's Sim3 programs.  Without this a shipping run pays the
        ~1.5 s BA-bucket retrace and the ~4 s Sim3 trace in the middle
        of the sequence — exactly the stall bench.py's warmups avoid
        (VERDICT r4 weak #4: the warm path must be the product path,
        not a bench-only configuration)."""
        def _run():
            self.tracker.warmup_ba()
            self.tracker.warmup_mirror()
            lc = self.loop_closer
            if lc is not None:
                lc.warmup_jit()

        self._warmup_started = True
        if block:
            _run()
        else:
            self._in_background(_run, "slam-warmup")

    def _in_background(self, fn, name: str):
        """Run a warmup on a daemon thread.  The frame loop does not
        depend on it (a warmup only compiles programs the loop would
        otherwise compile on first use), so its failure does not stop
        tracking: the exception is kept in ``warmup_errors`` for the
        caller to check, and shutdown() joins the thread."""

        def _target():
            try:
                fn()
            except Exception as e:  # kept for the caller; see docstring
                self.warmup_errors.append(e)

        th = threading.Thread(target=_target, name=name, daemon=True)
        self._warmup_threads.append(th)
        th.start()

    def _maybe_autowarmup(self):
        # Auto-warm on the first tracked frame, off the critical path.
        # Accelerator only: on CPU (tests) compiles are cheap and the
        # extra programs would slow every System-constructing test.
        if self._warmup_started:
            return
        self._warmup_started = True
        import jax

        if jax.devices()[0].platform != "cpu":
            self.warmup(block=False)

    # ------------------------------------------------------------------
    def track_stereo(self, img_left, img_right, timestamp: float = 0.0) -> np.ndarray:
        """Feed a rectified stereo pair; returns the 4x4 Tcw pose."""
        self._maybe_autowarmup()
        return self.tracker.process_stereo(img_left, img_right, timestamp)

    def track_monocular(self, img, timestamp: float = 0.0) -> np.ndarray:
        """Feed a single grayscale image; returns the 4x4 Tcw pose
        (identity until monocular initialization succeeds).  Mirrors
        the reference's System::TrackMonocular."""
        return self.tracker.process_mono(img, timestamp)

    def track_rgbd(self, img, depth, timestamp: float = 0.0) -> np.ndarray:
        import jax.numpy as jnp

        from ..frontend.frame import build_rgbd_frame

        self.tracker.frame_id += 1
        frame = build_rgbd_frame(jnp.asarray(img), jnp.asarray(depth), self.cfg)
        return self.tracker._track(frame, timestamp)

    # ------------------------------------------------------------------
    def _on_keyframe(self, kf_id: int):
        if self.localization_only or not self.use_loop_closing:
            return
        if self.voc is None:
            # Train a vocabulary on the fly (the reference ships a
            # 145 MB pre-trained ORBvoc.txt; we bootstrap one when none
            # is provided): accumulate the first few keyframes'
            # descriptors so the 10^3-word tree sees real appearance
            # diversity instead of one view.
            store = self.tracker.map
            descs = store.kf_desc[kf_id][store.kf_feat_valid[kf_id]]
            self._voc_corpus = getattr(self, "_voc_corpus", [])
            if len(descs):
                self._voc_corpus.append(descs)
            total = sum(len(d) for d in self._voc_corpus)
            if total < 600 and len(self._voc_corpus) < 3:
                return
            corpus = np.concatenate(self._voc_corpus)[:20000]
            # depth 4 -> 10^4 leaves: the 10^3-word tree was measured to
            # alias heavily on self-similar scenes — BoW candidates fired
            # a (always-failing, ~0.5 s) Sim3 attempt at nearly EVERY
            # keyframe and picked wrong winners at true revisits.  The
            # reference ships a 10^6-leaf vocabulary for the same reason.
            self.voc = Vocabulary.train(corpus, k=10, depth=4, seed=0)
            self._voc_corpus = []
        if self.loop_closer is None:
            self.loop_closer = LoopCloser(self.cfg, self.tracker.map, self.voc)
            self.loop_closer.gba_async = self.gba_async
            self.loop_closer.async_detect = self.async_loop
            # Mono maps drift in scale: loop Sim3 estimates s (the
            # reference's bFixScale = sensor != MONOCULAR).
            self.loop_closer.fix_scale = not self.tracker.is_mono
            self.tracker.reloc_candidates_fn = self._reloc_candidates

            def _drain_mapping():
                # Reference CorrectLoop order: LocalMapping drained
                # before the pose rewrite, so in-flight triangulation/
                # fuse/BA land instead of being epoch-discarded.
                self.tracker.poll_map_jobs(force=True)
                self.tracker.flush_pending_ba()

            self.loop_closer.pre_correct_hook = _drain_mapping
            # Pre-compile the Sim3/pose-graph programs off the critical
            # path (the first real loop otherwise eats a ~4 s trace).
            import jax

            if jax.devices()[0].platform != "cpu":
                self._in_background(
                    self.loop_closer.warmup_jit, "slam-loop-warmup"
                )
        # Apply a finished in-flight global BA before touching the map
        # (the reference applies GBA results between keyframes too).
        self.loop_closer.poll_global_ba()
        closed = self.loop_closer.process_keyframe(kf_id)
        if closed:
            self.n_loops_closed += 1
            # Tracking continues from the corrected keyframe pose.
            self.tracker.R = self.tracker.map.kf_R[kf_id].copy()
            self.tracker.t = self.tracker.map.kf_t[kf_id].copy()
            self.tracker.vel = None

    def _reloc_candidates(self, frame):
        if self.loop_closer is None:
            return []
        # _db_lock: the async detection worker mutates the inverted
        # index concurrently (ADVICE r3 #2 — a candidate could be
        # popped from db.bow between gather and score).
        with self.loop_closer._db_lock:
            return self.loop_closer.db.detect_relocalization_candidates(
                np.asarray(frame.desc), np.asarray(frame.valid)
            )

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Tracking-only: no new keyframes/landmarks (reference's
        ActivateLocalizationMode)."""
        self.localization_only = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.localization_only = False

    def reset(self):
        if self.loop_closer is not None:
            self.loop_closer.stop()
        self.tracker = Tracker(self.cfg)
        self.tracker.on_keyframe = self._on_keyframe
        self.loop_closer = None

    def shutdown(self):
        """Join outstanding asynchronous work (pipelined frames,
        deferred local BA, pending loop detection, in-flight global BA)
        — the reference's thread-join shutdown."""
        for th in self._warmup_threads:
            th.join()
        self.tracker.flush()
        self.tracker.flush_pending_ba()
        if self.loop_closer is not None:
            if self.loop_closer.flush():
                self.n_loops_closed += 1
            self.loop_closer.poll_global_ba(force=True)
            self.loop_closer.stop()

    # ------------------------------------------------------------------
    def save_trajectory_kitti(self, path):
        self.shutdown()
        save_trajectory_kitti(path, self.tracker.final_trajectory())

    def save_trajectory_tum(self, path):
        self.shutdown()
        save_trajectory_tum(path, self.tracker.final_trajectory())

    def save_keyframe_trajectory_tum(self, path):
        store = self.tracker.map
        traj = []
        for k in np.nonzero(store.kf_valid[: store._next_kf])[0]:
            traj.append(
                (
                    int(store.kf_frame_id[k]),
                    float(store.kf_timestamp[k]),
                    store.kf_R[k],
                    store.kf_t[k],
                    False,
                )
            )
        save_trajectory_tum(path, traj)

    # ------------------------------------------------------------------
    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self) -> str:
        return self.tracker.state
