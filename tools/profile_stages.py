"""Per-stage host-time profile of the full tracking pipeline.

Runs the same synthetic KITTI-shaped sequence as bench.py's
_bench_pipeline and prints the Tracker's StageTimer table — the
per-stage ms budget that explains the full_pipeline_fps number
(VERDICT r2 "next round" #1d).  Run on the GPU:

    python tools/profile_stages.py [n_frames] [--system]
"""

import os
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    n_frames = 60
    use_system = "--system" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if args:
        n_frames = int(args[0])

    from orb_line_slam_tpu.config import OrbConfig, SlamConfig
    from orb_line_slam_tpu.data.synthetic import SyntheticScene, circular_trajectory
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics

    cam = CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
        width=1241, height=376,
    )
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=2000, n_levels=8))
    scene = SyntheticScene(cam, n_points=700, seed=3)
    poses = circular_trajectory(n_frames, step=0.25)
    frames = [scene.render_stereo(R, t) for R, t in poses]

    if use_system:
        from orb_line_slam_tpu.pipeline.system import System

        sysm = System(cfg, async_loop=("--syncloop" not in sys.argv))
        tracker = sysm.tracker
        step = lambda i: sysm.track_stereo(*frames[i], timestamp=0.1 * i)  # noqa: E731
    else:
        from orb_line_slam_tpu.pipeline.tracking import Tracker

        tracker = Tracker(cfg)
        step = lambda i: tracker.process_stereo(*frames[i], timestamp=0.1 * i)  # noqa: E731

    warmup = 12
    for i in range(warmup):
        step(i)
    tracker.warmup_ba()
    tracker.warmup_mirror()
    tracker.timing.reset()
    t0 = time.perf_counter()
    for i in range(warmup, n_frames):
        step(i)
    dt = time.perf_counter() - t0
    n = n_frames - warmup
    print(f"\n{n} frames in {dt:.2f}s -> {n / dt:.2f} fps ({dt / n * 1e3:.1f} ms/frame)")
    kfs = sum(1 for s in tracker.stats if s.get("is_kf"))
    print(f"keyframes: {kfs}  map points: {int(tracker.map.pt_valid.sum())}\n")
    print(tracker.timing.format(n_frames=n))
    untracked = dt - sum(tracker.timing.acc.values())
    print(f"{'(untracked host/python)':<28}{untracked * 1e3:>10.1f}{'':>8}{'':>10}{untracked / n * 1e3:>10.2f}")


if __name__ == "__main__":
    main()
