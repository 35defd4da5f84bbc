"""The pinned closed-circuit accuracy run.

A wide-FOV stereo rig (640x320, 90 degrees) orbits an 8 m-radius circle
for 1.12 laps, so the last keyframes revisit the first ones, with
per-frame sensor noise: the full pixels -> BoW detect -> Sim3 ->
CorrectLoop -> global BA chain runs and closes the loop.  The KITTI
camera's narrow FOV on clean synthetic odometry drifts ~0.1%, below the
Sim3 edge's noise floor, which makes a closure ATE-neutral; this rig
drifts enough that the closure measurably pays.

Used by bench.py and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

N_FRAMES = 170
RADIUS_M = 8.0
LAPS = 1.12


def run_loop_circuit(
    use_loop: bool = True,
    shipping: bool = False,
    map_cfg=None,
):
    """Run the System over the circuit; returns (ate_m, system).

    shipping=False pins the deterministic schedule (synchronous
    mapping, loop detection and global BA, pipeline depth 0): async
    applies land at wall-clock-dependent frames, as in the reference's
    own multithreaded runs, so only the pinned schedule makes a
    regression attributable.  ``map_cfg`` overrides the circuit's
    128-KF / 16k-point capacities."""
    from ..config import LineConfig, MapConfig, OrbConfig, SlamConfig
    from ..data.synthetic import SyntheticScene, loop_circuit_trajectory
    from ..geometry.camera import CameraIntrinsics
    from ..pipeline.system import System
    from .trajectory import ate_rmse

    vcam = CameraIntrinsics(
        fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0,
        width=640, height=320,
    )
    if map_cfg is None:
        map_cfg = MapConfig(max_keyframes=128, max_points=16384,
                            max_lines=1024, local_window=8, local_points=4096)
    cfg = SlamConfig(
        camera=vcam, orb=OrbConfig(n_features=1000, n_levels=4),
        lines=LineConfig(enabled=True, n_lines=64),
        map=map_cfg,
    )
    poses = loop_circuit_trajectory(N_FRAMES, radius=RADIUS_M, laps=LAPS)
    scene = SyntheticScene(
        vcam, n_points=1600, seed=5, extent=((-24, 40), (-4, 4), (-32, 32))
    )
    scene.noise_sigma = 6.0
    sysm = System(cfg, use_loop_closing=use_loop, async_loop=False)
    if not shipping:
        sysm.tracker.async_mapping = False
        sysm.tracker.pipeline_depth = 0
        sysm.gba_async = False
    for i, (R, t) in enumerate(poses):
        left, right = scene.render_stereo(R, t)
        sysm.track_stereo(left, right, timestamp=0.1 * i)
    sysm.shutdown()
    est = np.stack(
        [-R.T @ t for (_, _, R, t, _) in sysm.tracker.final_trajectory()]
    )
    gt = np.stack([-R.T @ t for (R, t) in poses])
    return float(ate_rmse(est, gt, align=True)), sysm
