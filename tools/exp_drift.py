"""Open-loop drift of the tracker on the current JAX platform.

Run on the GPU and on the CPU and compare (VERDICT r4 weak #3):
  python tools/exp_drift.py
  JAX_PLATFORMS=cpu python tools/exp_drift.py
"""
import os
import sys

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # Apply the platform choice through the config as well as the env.
    import jax

    jax.config.update("jax_platforms", "cpu")


def main():
    import jax

    from orb_line_slam_tpu.config import (
        LineConfig, MapConfig, OrbConfig, SlamConfig,
    )
    from orb_line_slam_tpu.data.synthetic import (
        SyntheticScene, loop_circuit_trajectory,
    )
    from orb_line_slam_tpu.eval.trajectory import ate_rmse
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
    from orb_line_slam_tpu.pipeline.system import System

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 170
    vcam = CameraIntrinsics(
        fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0,
        width=640, height=320,
    )
    cfg = SlamConfig(
        camera=vcam, orb=OrbConfig(n_features=1000, n_levels=4),
        lines=LineConfig(enabled=True, n_lines=64),
        map=MapConfig(max_keyframes=128, max_points=16384, max_lines=1024,
                      local_window=8, local_points=4096),
    )
    poses = loop_circuit_trajectory(n_frames, radius=8.0, laps=1.12)
    scene = SyntheticScene(
        vcam, n_points=1600, seed=5, extent=((-24, 40), (-4, 4), (-32, 32))
    )
    scene.noise_sigma = 6.0
    sysm = System(cfg, use_loop_closing=False, async_loop=False)
    sysm.tracker.async_mapping = False
    sysm.tracker.pipeline_depth = 0
    sysm.gba_async = False
    for i, (R, t) in enumerate(poses):
        l, r = scene.render_stereo(R, t)
        sysm.track_stereo(l, r, timestamp=0.1 * i)
    sysm.shutdown()
    est = np.stack(
        [-R.T @ t for (_, _, R, t, _) in sysm.tracker.final_trajectory()]
    )
    gt = np.stack([-R.T @ t for (R, t) in poses])
    ate = float(ate_rmse(est, gt, align=True))
    end_err = float(np.linalg.norm(est[-1] - gt[-1]))
    print(
        f"platform={jax.devices()[0].platform} frames={n_frames} "
        f"ate={ate:.4f} m end_err={end_err:.4f} m "
        f"kfs={int(sysm.map.kf_valid.sum())}"
    )


if __name__ == "__main__":
    main()
