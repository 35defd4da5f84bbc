#!/usr/bin/env python
"""Stereo EuRoC driver — the Examples/Stereo/stereo_euroc.cc analog.

Usage:
  python examples/stereo_euroc.py SETTINGS_YAML MAV0_DIR \
      [--out CameraTrajectory.txt] [--max-frames N]

The settings YAML may be the reference's EuRoC.yaml verbatim (the
LEFT.*/RIGHT.* rectification blocks are honored).
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
    ap.add_argument("mav0")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None)
    args = ap.parse_args()

    from orb_line_slam_tpu.config import load_settings
    from orb_line_slam_tpu.data.euroc import EurocStereoSequence
    from orb_line_slam_tpu.pipeline.system import System

    cfg = load_settings(args.settings)
    seq = EurocStereoSequence(args.mav0, rectify=cfg.rectify)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    print(f"EuRoC sequence: {n} stereo pairs")

    slam = System(cfg, vocabulary=args.vocab)
    times = []
    for i in range(n):
        img_l, img_r, ts = seq[i]
        t0 = time.perf_counter()
        slam.track_stereo(img_l, img_r, ts)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}: state={slam.tracking_state()}")

    times = np.array(times[2:])
    print(
        f"tracking time: median {1e3 * np.median(times):.1f} ms, "
        f"mean {1e3 * times.mean():.1f} ms"
    )
    slam.save_trajectory_tum(args.out)
    print(f"trajectory written to {args.out}")


if __name__ == "__main__":
    main()
