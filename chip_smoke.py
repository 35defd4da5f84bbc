#!/usr/bin/env python3
"""Smoke run of the stereo point+line SLAM main path on one GPU.

    python chip_smoke.py               # one card: parity, KITTI stereo, loop circuit
    python chip_smoke.py --four-cards  # four cards: sharded global BA only

One card, in one process:

1. parity: every contract of ``eval/parity.py`` (stereo front-end, line
   front-end, motion-only pose optimization, the fused track step), the
   card against the host CPU at the KITTI 00-02 shape;
2. stereo pipeline: ``System`` built from examples/configs/KITTI00-02.yaml
   (1241x376, 2000 features, 8 levels, 128 lines, 512 KF / 65,536-point
   map, pipeline depth 2, async mapping, loop closing on) over 60 rendered
   frames; tracking must end OK with keyframes made and local BA applied;
3. loop circuit: the pinned closed circuit of ``eval/circuit.py`` (640x320,
   170 frames, lines on), run five times; in each run at least one loop
   must close and global BA must be applied, and the median ATE must stay
   within 1.5x the same run's CPU ATE.

With ``--four-cards``: the landmark-sharded CG global BA on a 4-card mesh
against ``bundle_adjust_cg`` on one card (256 cameras, 65,536 landmarks,
262,144 observations), then one ``System`` loop circuit at the MapConfig
defaults, which must route global BA to the sharded solver.

Any failed check, exception or warmup error ends the run with a non-zero
exit.  The last line of standard output is one JSON object naming the
device.  There is no CPU fallback: without a GPU the script exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402

# ATE of the pinned loop circuit (eval/circuit.py, run_loop_circuit(True))
# on a host CPU (x86-64, JAX 0.9.0; 1 loop closed, 51 keyframes), measured
# once with this code and recorded in PERF.md.  The circuit's ATE is
# chaotic (scatter-adds on the GPU sum in a varying order): single runs
# on the H100 have read 0.60x-2.31x of it, so the gate takes the median
# of CIRCUIT_RUNS runs and guards against gross failures of loop
# correction.  Precision faults are the parity phase's to catch.
CPU_CIRCUIT_ATE_M = 0.0356
CIRCUIT_ATE_FACTOR = 1.5
CIRCUIT_RUNS = 5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def phase(name: str):
    print(f"\n=== {name} ===", flush=True)
    return time.perf_counter()


def card_header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    print(f"jax {jax.__version__}; devices {jax.devices()}")
    print(f"compile cache: {os.environ['JAX_COMPILATION_CACHE_DIR']}")


def parity_phase(gpu):
    from orb_line_slam_tpu.eval.parity import run_parity

    t0 = phase("parity: card vs host CPU")
    print(
        "matmul precision: jax default "
        f"{jax.config.jax_default_matmul_precision or 'unset (per-op)'}; "
        "BA, pose graph, Sim3, geometry and image filters pinned HIGHEST; "
        "BRIEF, IC angle and Hamming exact integer"
    )
    checks = run_parity(gpu)
    for c in checks:
        print(c)
    failed = [c for c in checks if not c.ok]
    print(f"parity: {len(checks) - len(failed)}/{len(checks)} ok "
          f"({time.perf_counter() - t0:.1f} s)")
    check(not failed, f"parity failed: {[str(c) for c in failed]}")


def stereo_pipeline_phase(n_frames: int = 60, warm: int = 12):
    from orb_line_slam_tpu.data.synthetic import circular_trajectory
    from orb_line_slam_tpu.eval.parity import SETTINGS, kitti_scene
    from orb_line_slam_tpu.eval.trajectory import ate_rmse
    from orb_line_slam_tpu.pipeline.system import System

    t0 = phase("stereo pipeline: KITTI00-02 settings, shipping defaults")
    sysm = System(str(SETTINGS))
    cfg = sysm.cfg
    print(f"{cfg.camera.width}x{cfg.camera.height}, {cfg.orb.n_features} features, "
          f"{cfg.orb.n_levels} levels, lines {cfg.lines.enabled} ({cfg.lines.n_lines}), "
          f"map {cfg.map.max_keyframes} KF / {cfg.map.max_points} points, "
          f"pipeline depth {sysm.tracker.pipeline_depth}, "
          f"async mapping {sysm.tracker.async_mapping}")
    scene = kitti_scene(cfg)
    poses = circular_trajectory(n_frames, step=0.25)
    frames = [scene.render_stereo(R, t) for R, t in poses]
    for i in range(warm):
        sysm.track_stereo(*frames[i], timestamp=0.1 * i)
    sysm.warmup(block=True)
    ba_applied = sysm.tracker.timing.cnt.get("ba_apply", 0)
    sysm.tracker.timing.reset()
    t_win = time.perf_counter()
    for i in range(warm, n_frames):
        sysm.track_stereo(*frames[i], timestamp=0.1 * i)
    sysm.tracker.flush()
    dt = time.perf_counter() - t_win
    ba_applied += sysm.tracker.timing.cnt.get("ba_apply", 0)
    table = sysm.tracker.timing.format(n_frames - warm)
    sysm.shutdown()
    est = np.stack([-R.T @ t for (_, _, R, t, _) in sysm.tracker.final_trajectory()])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    ate = float(ate_rmse(est, gt, align=True))
    n_kf = int(sysm.map.kf_valid.sum())
    print(f"frames/s over frames {warm}-{n_frames - 1}: {(n_frames - warm) / dt:.2f} "
          f"(host clock, after warmup)")
    print(f"ATE {ate:.4f} m over {n_frames} frames; keyframes {n_kf}; "
          f"local BA applied {ba_applied}; state {sysm.tracking_state()}")
    print(table)
    check(not sysm.warmup_errors, f"warmup errors: {sysm.warmup_errors!r}")
    check(sysm.tracking_state() == "OK", f"tracking state {sysm.tracking_state()}")
    check(n_kf >= 2, f"only {n_kf} keyframes")
    check(ba_applied >= 1, "local BA was never applied")
    check(np.isfinite(ate), "non-finite ATE")
    print(f"stereo pipeline ok ({time.perf_counter() - t0:.1f} s)")


def loop_circuit_phase():
    from orb_line_slam_tpu.eval.circuit import N_FRAMES, run_loop_circuit

    t0 = phase("loop circuit: 640x320, lines on, pinned schedule")
    ates = []
    for run in range(CIRCUIT_RUNS):
        ate, sysm = run_loop_circuit(True)
        lc = sysm.loop_closer
        print(f"run {run}: ATE {ate:.5f} m over {N_FRAMES} frames; loops closed "
              f"{sysm.n_loops_closed}; global BA applied "
              f"{lc.n_gba_applied if lc else 0} via {lc.gba_route if lc else None}; "
              f"keyframes {int(sysm.map.kf_valid.sum())}", flush=True)
        check(not sysm.warmup_errors, f"warmup errors: {sysm.warmup_errors!r}")
        check(sysm.n_loops_closed >= 1, f"run {run}: no loop closed")
        check(lc is not None and lc.n_gba_applied >= 1,
              f"run {run}: global BA was never applied")
        ates.append(ate)
    med = float(np.median(ates))
    limit = CIRCUIT_ATE_FACTOR * CPU_CIRCUIT_ATE_M
    print(f"median ATE {med:.5f} m (limit {limit:.5f} = {CIRCUIT_ATE_FACTOR} x "
          f"CPU {CPU_CIRCUIT_ATE_M})")
    check(med <= limit, f"median ATE {med:.5f} m above {limit:.5f} m")
    print(f"loop circuit ok ({time.perf_counter() - t0:.1f} s)")


def four_card_phase():
    from __graft_entry__ import dryrun_multichip
    from orb_line_slam_tpu.config import MapConfig
    from orb_line_slam_tpu.eval.circuit import run_loop_circuit

    t0 = phase("four cards (a): sharded CG global BA vs one card")
    res = dryrun_multichip(4)
    check(res["pose_agreement"] <= 1e-4,
          f"sharded vs one-card pose agreement {res['pose_agreement']:.2e} > 1e-4")
    print(f"(a) ok ({time.perf_counter() - t0:.1f} s)")

    t0 = phase("four cards (b): System loop circuit at the MapConfig defaults")
    ate, sysm = run_loop_circuit(True, map_cfg=MapConfig())
    lc = sysm.loop_closer
    print(f"ATE {ate:.4f} m; loops closed {sysm.n_loops_closed}; global BA route "
          f"{lc.gba_route if lc else None}, applied {lc.n_gba_applied if lc else 0}")
    check(not sysm.warmup_errors, f"warmup errors: {sysm.warmup_errors!r}")
    check(sysm.n_loops_closed >= 1, "no loop closed")
    check(lc is not None and lc.gba_route == "sharded_cg",
          f"global BA took route {lc.gba_route if lc else None}, not sharded_cg")
    check(lc.n_gba_applied >= 1, "sharded global BA was never applied")
    print(f"(b) ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded global-BA phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (jax.devices() = {devices})", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    import orb_line_slam_tpu  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    try:
        card_header()
        if args.four_cards:
            four_card_phase()
        else:
            parity_phase(devices[0])
            stereo_pipeline_phase()
            loop_circuit_phase()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(f"\nall phases ok in {time.perf_counter() - t_start:.1f} s")
    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": need},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
