#!/usr/bin/env python
"""Stereo KITTI driver — the Examples/Stereo/stereo_kitti.cc analog.

Usage:
  python examples/stereo_kitti.py SETTINGS_YAML SEQUENCE_DIR \
      [--out CameraTrajectory.txt] [--max-frames N] [--vocab ORBvoc.txt]

Loads the image list, tracks every stereo pair, reports per-frame timing
(median/mean as the reference's main() does) and writes the trajectory
in KITTI format.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import os

if os.environ.get("JAX_PLATFORMS"):
    # Apply the platform choice through the config as well as the env.
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--no-loop", action="store_true")
    args = ap.parse_args()

    from orb_line_slam_tpu.data.kitti import KittiStereoSequence
    from orb_line_slam_tpu.pipeline.system import System

    seq = KittiStereoSequence(args.sequence)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    print(f"KITTI sequence: {n} stereo pairs")

    slam = System(
        args.settings, vocabulary=args.vocab,
        use_loop_closing=not args.no_loop,
    )

    times = []
    for i in range(n):
        img_l, img_r, ts = seq[i]
        t0 = time.perf_counter()
        slam.track_stereo(img_l, img_r, ts)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            st = slam.tracker.stats[-1] if slam.tracker.stats else {}
            print(
                f"frame {i}: state={slam.tracking_state()} "
                f"inliers={st.get('inliers', '-')} "
                f"kf={slam.map.n_keyframes()} {1e3 * times[-1]:.0f} ms"
            )

    slam.shutdown()
    times = np.array(times[2:])  # drop compile frames
    print(
        f"tracking time: median {1e3 * np.median(times):.1f} ms, "
        f"mean {1e3 * times.mean():.1f} ms"
    )
    print(f"loops closed: {slam.n_loops_closed}")
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory written to {args.out}")


if __name__ == "__main__":
    main()
