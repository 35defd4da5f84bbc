"""Benchmark: stereo front-end frames/sec on one accelerator.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Measures the per-frame device program (dual ORB extraction + stereo
row-band matching + SAD refine, KITTI-sized 376x1241 images, 2000
features) in steady state.  vs_baseline is against the reference
family's CPU tracking front-end at ~30 fps (25-60 ms/frame on a desktop
i7 — SURVEY.md §6 planning figures; BASELINE.json has no published
numbers and the reference mount was empty)."""

import json
import os
import time

import numpy as np

# Persistent XLA compilation cache at a fixed path (the path is part of
# the cache key), unless JAX_COMPILATION_CACHE_DIR already names one.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(os.path.dirname(__file__), ".jax_cache")
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

BASELINE_FPS = 30.0


def main():
    import jax
    import jax.numpy as jnp

    from orb_line_slam_tpu.config import OrbConfig, SlamConfig
    from orb_line_slam_tpu.frontend.frame import build_stereo_frame
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics

    cam = CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
        width=1241, height=376,
    )
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=2000, n_levels=8))

    rng = np.random.default_rng(0)
    # Textured random frames (content doesn't matter for throughput:
    # every kernel is static-shape and data-independent).
    imgs = [
        (
            jnp.asarray(rng.integers(0, 255, (376, 1241), dtype=np.uint8)),
            jnp.asarray(rng.integers(0, 255, (376, 1241), dtype=np.uint8)),
        )
        for _ in range(4)
    ]

    # Frames are chained through a checksum carry and fetched ONCE, so
    # the measurement is amortized device throughput.
    @jax.jit
    def step(carry, l, r):
        out = build_stereo_frame(l, r, cfg)
        return carry + jnp.sum(out.depth) + jnp.sum(out.response)

    acc = step(jnp.float32(0), *imgs[0])  # warmup/compile
    float(acc)

    n_iters = 40
    t0 = time.perf_counter()
    acc = jnp.float32(0)
    for i in range(n_iters):
        acc = step(acc, *imgs[i % len(imgs)])
    float(acc)  # single completion barrier
    dt = time.perf_counter() - t0
    fps = n_iters / dt

    # Secondary: local-BA LM iteration time (16 cams + 16 fixed, 4096
    # landmarks, 16k observations — a KITTI-scale local window).
    ba_ms = _bench_local_ba(jax, jnp, cam)

    # Tertiary: FULL System pipeline — points + lines, loop closing ON,
    # async mapping — over a synthetic KITTI-sized sequence, plus the
    # trajectory ATE of a longer drift+revisit run (the accuracy number
    # the driver records next to throughput).
    pipe_fps, pipe_stats = _bench_pipeline(cam)
    ate, ate_extra = _bench_ate()

    # Long-horizon endurance (VERDICT r4 #4): 1,500 frames, 2 genuine
    # revisits, capacity-pressure culling, injected loss -> reloc.
    from orb_line_slam_tpu.eval.endurance import run_endurance

    ate_extra.update(run_endurance(n_frames=1500, shipping=True))

    print(
        json.dumps(
            {
                "metric": "stereo_frontend_fps_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "extra": {
                    "local_ba_iter_ms": round(ba_ms, 2),
                    "full_pipeline_fps": round(pipe_fps, 2),
                    "full_pipeline_vs_baseline": round(pipe_fps / BASELINE_FPS, 3),
                    "ate_rmse_synth_m": ate,
                    **ate_extra,
                    **pipe_stats,
                    "platform": jax.devices()[0].platform,
                },
            }
        )
    )


def _bench_local_ba(jax, jnp, cam):
    from orb_line_slam_tpu.backend.local_ba import bundle_adjust

    rng = np.random.default_rng(1)
    C, P, O = 32, 4096, 16384
    pts = np.stack(
        [rng.uniform(-20, 20, P), rng.uniform(-5, 5, P), rng.uniform(5, 60, P)], -1
    ).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[:, 0] = np.arange(C) * 0.5
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_lm = rng.integers(0, P, O).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_lm]) + t[obs_cam]
    z = np.maximum(xc[:, 2], 1.0)
    obs = np.stack(
        [
            cam.fx * xc[:, 0] / z + cam.cx,
            cam.fy * xc[:, 1] / z + cam.cy,
            cam.fx * xc[:, 0] / z + cam.cx - cam.bf / z,
        ],
        -1,
    ).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:16] = True
    args = (
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(fixed),
        jnp.asarray(pts), jnp.ones(P, bool),
        jnp.asarray(obs_cam), jnp.asarray(obs_lm), jnp.asarray(obs),
        jnp.zeros(O, jnp.int32), jnp.ones(O, bool),
    )
    n_iters = 15  # iters1=5 + iters2=10

    def run():
        res = bundle_adjust(*args, cam)
        return float(res.chi2)

    run()  # compile
    t0 = time.perf_counter()
    run()
    run()
    return (time.perf_counter() - t0) / 2 / n_iters * 1000.0


def _bench_pipeline(cam, n_frames: int = 60, warmup: int = 12):
    """End-to-end SYSTEM fps — points + lines + loop closing, async
    mapping — on a synthetic KITTI-sized stereo sequence (pre-rendered
    on host, as the examples' imread is outside the reference's timed
    region too).  Also returns the per-stage host-ms table."""
    import time

    from orb_line_slam_tpu.config import OrbConfig, SlamConfig
    from orb_line_slam_tpu.data.synthetic import SyntheticScene, circular_trajectory
    from orb_line_slam_tpu.pipeline.system import System

    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=2000, n_levels=8))
    scene = SyntheticScene(cam, n_points=700, seed=3)
    poses = circular_trajectory(n_frames, step=0.25)
    frames = [scene.render_stereo(R, t) for R, t in poses]

    sysm = System(cfg)
    for i in range(warmup):
        sysm.track_stereo(*frames[i], timestamp=0.1 * i)
    if sysm.loop_closer is not None:
        sysm.loop_closer.warmup_jit()
    sysm.tracker.warmup_ba()
    sysm.tracker.warmup_mirror()
    sysm.tracker.timing.reset()
    t0 = time.perf_counter()
    for i in range(warmup, n_frames):
        sysm.track_stereo(*frames[i], timestamp=0.1 * i)
    dt = time.perf_counter() - t0
    n = n_frames - warmup
    stage_ms = {
        f"stage_ms_{name}": row["ms_per_frame"]
        for name, row in list(sysm.tracker.timing.table(n).items())[:6]
    }
    return n / dt, stage_ms


def _bench_ate():
    """ATE RMSE of the full System on the pinned closed circuit
    (eval/circuit.py), with and without loop closing, plus the
    shipping-default schedule's ATE."""
    from orb_line_slam_tpu.eval.circuit import (
        LAPS,
        N_FRAMES,
        RADIUS_M,
        run_loop_circuit,
    )

    ate, sysm = run_loop_circuit(True)
    ate_noloop, _ = run_loop_circuit(False)
    ate_ship, sysm_ship = run_loop_circuit(True, shipping=True)
    extra = {
        "ate_synth_path_m": round(2 * np.pi * RADIUS_M * LAPS, 1),
        "ate_synth_frames": N_FRAMES,
        "ate_synth_keyframes": int(sysm.map.kf_valid.sum()),
        "ate_synth_loops": int(sysm.n_loops_closed),
        "ate_synth_noloop_m": round(ate_noloop, 4),
        "ate_rmse_ship_m": round(ate_ship, 4),
        "ate_ship_loops": int(sysm_ship.n_loops_closed),
    }
    return round(ate, 4), extra


if __name__ == "__main__":
    main()
