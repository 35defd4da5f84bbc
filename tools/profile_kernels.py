"""Per-device-program timing table, printed to standard output.

Times every hot device program of the pipeline in isolation on the
accelerator (host clock around n chained dispatches ending in
block_until_ready, after a warm-up) and prints one table headed by the
device and, on a GPU, the card's name and power limit as nvidia-smi
reports them (a card set below its maximum power runs slower).

Run:  python tools/profile_kernels.py
"""

import os
import subprocess
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orb_line_slam_tpu.config import OrbConfig, SlamConfig
    from orb_line_slam_tpu.data.synthetic import SyntheticScene, circular_trajectory
    from orb_line_slam_tpu.frontend.frame import build_stereo_frame
    from orb_line_slam_tpu.frontend.line_extractor import build_line_features
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
    from orb_line_slam_tpu.pipeline.tracking import Tracker

    cam = CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
        width=1241, height=376,
    )
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=2000, n_levels=8))
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if dev.platform == "gpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip())

    rows = []

    def bench(name, dispatch, n=30, note=""):
        for _ in range(3):  # compile + warm
            out = dispatch()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = dispatch()
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n * 1e3
        rows.append((name, ms, note))
        print(f"{name:<38}{ms:9.2f} ms  {note}")
        return out

    rng = np.random.default_rng(0)
    l = jnp.asarray(rng.integers(0, 255, (376, 1241), dtype=np.uint8))
    r = jnp.asarray(rng.integers(0, 255, (376, 1241), dtype=np.uint8))

    bench("frontend/build_stereo_frame", lambda: build_stereo_frame(l, r, cfg),
          note="2000 feats, 8 levels, KITTI-size pair")
    bench("frontend/build_line_features",
          lambda: build_line_features(l, r, cfg.camera, cfg.lines),
          note="128 lines/image + LBD + stereo assoc")

    # Build a small live map for the per-frame/per-keyframe programs.
    scene = SyntheticScene(cam, n_points=700, seed=3)
    poses = circular_trajectory(30, step=0.25)
    frames = [scene.render_stereo(R, t) for R, t in poses]
    tracker = Tracker(cfg)
    tracker.async_mapping = False
    for i in range(30):
        tracker.process_stereo(*frames[i], timestamp=0.1 * i)
    tracker.flush()

    fr = build_stereo_frame(jnp.asarray(frames[10][0]), jnp.asarray(frames[10][1]), cfg)
    np.asarray(fr.xy)
    lf = build_line_features(
        jnp.asarray(frames[10][0]), jnp.asarray(frames[10][1]), cfg.camera,
        cfg.lines,
    )
    np.asarray(lf.p0)
    bench("tracking/track_step (fused)",
          lambda: tracker._dispatch_track_step(fr, lf).packed,
          note="A+B pose solves, PnP, local-map+line search, joint opt")

    from orb_line_slam_tpu.slam_map.fuse import dispatch_fuse
    from orb_line_slam_tpu.slam_map.triangulation import dispatch_triangulation

    kf = tracker.ref_kf
    ids, _ = tracker.map.covisible_keyframes(kf, min_weight=10, max_n=3)
    bench("mapping/triangulation (3 pairs)",
          lambda: dispatch_triangulation(
              tracker.map, kf, ids, cfg.camera, cfg.orb.scale_factor,
              kf_frames=tracker._kf_frames)["packed"],
          note="epipolar-gated Hamming + DLT + checks")
    bench("mapping/fuse (3 nbrs + reverse)",
          lambda: dispatch_fuse(
              tracker.map, kf, ids, cfg.camera, cfg.orb.level_scales,
              kf_frames=tracker._kf_frames)["packed"],
          note="bidirectional projection search")

    t0 = time.perf_counter()
    tracker._local_ba(kf, defer=False)
    ba1 = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tracker._local_ba(kf, defer=False)
    ba2 = (time.perf_counter() - t0) * 1e3
    rows.append(("mapping/local BA point+line (15 LM iters)", min(ba1, ba2),
                 "C=24 P=4096 O=12288 bucket, dense Schur"))
    print(f"{'mapping/local BA point+line':<38}{min(ba1, ba2):9.2f} ms")

    from orb_line_slam_tpu.backend.pose_opt import pose_optimize
    N = 2000
    pts = jnp.asarray(rng.uniform(-10, 10, (N, 3)).astype(np.float32))
    obs = jnp.asarray(rng.uniform(0, 300, (N, 3)).astype(np.float32))
    bench("backend/pose_optimize 4x10",
          lambda: pose_optimize(jnp.eye(3), jnp.zeros(3), pts, obs,
                                jnp.zeros(N, jnp.int32), jnp.ones(N, bool),
                                cfg.camera).R,
          note="motion-only BA, 2000 obs")

    from orb_line_slam_tpu.backend.local_ba import bundle_adjust
    C, P, O = 24, 4096, 12288
    Rb = jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)))
    tb = jnp.zeros((C, 3))
    ptsb = jnp.asarray(rng.uniform(-10, 10, (P, 3)).astype(np.float32))
    oc = jnp.asarray(rng.integers(0, C, O).astype(np.int32))
    ol = jnp.asarray(rng.integers(0, P, O).astype(np.int32))
    ouv = jnp.asarray(rng.uniform(0, 300, (O, 3)).astype(np.float32))
    fixed = jnp.zeros(C, bool).at[0].set(True)
    out = bench("backend/bundle_adjust (15 LM iters)",
                lambda: bundle_adjust(Rb, tb, fixed, ptsb, jnp.ones(P, bool),
                                      oc, ol, ouv, jnp.zeros(O, jnp.int32),
                                      jnp.ones(O, bool), cfg.camera).chi2,
                n=5, note=f"points only, C={C} P={P} O={O}")
    per_iter = rows[-1][1] / 15
    rows.append(("backend/BA LM iteration", per_iter, "derived: total/15"))
    print(f"{'backend/BA LM iteration':<38}{per_iter:9.2f} ms")

    from orb_line_slam_tpu.loop.vocabulary import Vocabulary
    voc = Vocabulary.train(
        rng.integers(0, 256, (4000, 32), dtype=np.uint8), k=10, depth=3
    )
    descs = rng.integers(0, 256, (2048, 32), dtype=np.uint8)
    bench("loop/BoW transform (2048 desc)",
          lambda: voc.dispatch_transform(descs),
          note="3-level batched 10-way Hamming descent")
    voc100k = Vocabulary.synthesize(k=10, depth=5, seed=0)
    bench("loop/BoW transform 10^5 words (2048 desc)",
          lambda: voc100k.dispatch_transform(descs),
          note="5-level descent, 100k-leaf synthesized tree")
    voc1m = Vocabulary.synthesize(k=10, depth=6, seed=0)
    bench("loop/BoW transform 10^6 words (2048 desc)",
          lambda: voc1m.dispatch_transform(descs),
          note="6-level descent, 1M-leaf tree (reference ORBvoc scale)")

    print(f"\n{'program':<44}{'ms':>9}  shape / note")
    for name, ms, note in rows:
        print(f"{name:<44}{ms:9.2f}  {note}")

if __name__ == "__main__":
    main()
