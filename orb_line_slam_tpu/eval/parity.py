"""Accelerator-versus-CPU parity contracts for the main path.

Each contract runs one device program on the accelerator and on the
host CPU, from the same inputs in one process, and bounds the distance
between the two results:

- ``build_stereo_frame``: keypoint sets nearly identical, coordinates
  within half a pixel, median descriptor distance <= 1 bit, stereo
  depths within 1% — this is where a reduced-precision filter once
  flipped borderline BRIEF bits and halved tracking inliers;
- ``build_line_features``: line sets nearly identical (the check that
  fails line filters run in TF32), endpoints within 1 px, LBD
  descriptors within a few bits, endpoint depths within 2%;
- ``pose_optimize``: motion-only BA from the same inputs lands within
  1e-3 (rotation entries) and 5e-3 m, inlier counts within 3 (f32
  accumulation order differs over 40 LM iterations);
- ``track_step``: the fused per-frame tracking program, held to the
  pose contract of ``pose_optimize``.

The front-end contracts run at the KITTI 00-02 shape (1241x376, 2000
ORB features over 8 levels, 128 lines) on a rendered stereo pair.
Used by chip_smoke.py and tests/test_gpu_parity.py.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

SETTINGS = Path(__file__).resolve().parents[2] / "examples" / "configs" / "KITTI00-02.yaml"


@dataclasses.dataclass(frozen=True)
class Check:
    """One measured distance against its limit (``upper``: the value
    must not exceed the limit; otherwise it must reach it)."""

    contract: str
    name: str
    value: float
    limit: float
    upper: bool = True

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.upper else self.value >= self.limit

    def __str__(self) -> str:
        op = "<=" if self.upper else ">="
        mark = "ok" if self.ok else "FAIL"
        return f"{self.contract:<20} {self.name:<34} {self.value:.6g} {op} {self.limit:g}  {mark}"


def kitti_config():
    """The KITTI 00-02 settings with the shipping line front-end."""
    from ..config import load_settings

    return load_settings(SETTINGS)


def kitti_scene(cfg):
    from ..data.synthetic import SyntheticScene

    return SyntheticScene(cfg.camera, n_points=700, seed=3)


def _on(device, fn, *args, **kwargs):
    """Run fn with inputs placed on ``device``; results come back as
    numpy."""
    with jax.default_device(device):
        args = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, device)
            if isinstance(a, (np.ndarray, jax.Array)) else a,
            args,
        )
        return jax.device_get(fn(*args, **kwargs))


def _set_agreement(va, vb):
    return float((np.asarray(va) == np.asarray(vb)).mean())


def _hamming(a, b):
    return np.unpackbits(np.asarray(a) ^ np.asarray(b), axis=1).sum(1)


def frontend_checks(device, ref, cfg, iml, imr) -> list[Check]:
    from ..frontend.frame import build_stereo_frame

    fa = _on(device, build_stereo_frame, iml, imr, cfg)
    fb = _on(ref, build_stereo_frame, iml, imr, cfg)
    c = "build_stereo_frame"
    both = fa.valid & fb.valid
    out = [
        Check(c, "valid-mask agreement", _set_agreement(fa.valid, fb.valid), 0.98, upper=False),
        Check(c, "keypoint max divergence px", float(np.abs(fa.xy[both] - fb.xy[both]).max()), 0.51),
        Check(c, "median descriptor distance bits", float(np.median(_hamming(fa.desc[both], fb.desc[both]))), 1.0),
    ]
    da, db = fa.depth[both], fb.depth[both]
    hit = (da > 0) & (db > 0)
    rel = np.abs(da[hit] - db[hit]) / np.maximum(db[hit], 1e-6)
    out += [
        Check(c, "stereo-hit agreement", _set_agreement(da > 0, db > 0), 0.95, upper=False),
        Check(c, "share of depths within 1%", float((rel < 0.01).mean()), 0.95, upper=False),
    ]
    return out


def line_checks(device, ref, cfg, iml, imr) -> list[Check]:
    from ..frontend.line_extractor import build_line_features

    la = _on(device, build_line_features, iml, imr, cfg.camera, cfg.lines)
    lb = _on(ref, build_line_features, iml, imr, cfg.camera, cfg.lines)
    c = "build_line_features"
    both = la.valid & lb.valid
    # Full-f32 line filters agree on every slot on the H100; with the
    # Sobel and coherence filters in TF32, 8 of 128 slots differ (0.9375).
    out = [
        Check(c, "valid-mask agreement", _set_agreement(la.valid, lb.valid), 0.98, upper=False),
        Check(c, "common lines", float(both.sum()), 8, upper=False),
    ]
    if both.sum() == 0:
        return out
    d_ep = np.maximum(
        np.abs(la.p0[both] - lb.p0[both]).max(-1),
        np.abs(la.p1[both] - lb.p1[both]).max(-1),
    )
    out += [
        Check(c, "median endpoint divergence px", float(np.median(d_ep)), 1.0),
        Check(c, "median LBD distance bits", float(np.median(_hamming(la.desc[both], lb.desc[both]))), 8),
    ]
    for name, da, db in (("depth0", la.depth0[both], lb.depth0[both]),
                         ("depth1", la.depth1[both], lb.depth1[both])):
        hit = (da > 0) & (db > 0)
        if hit.sum() >= 3:
            rel = np.abs(da[hit] - db[hit]) / np.maximum(db[hit], 1e-6)
            out.append(Check(c, f"median {name} relative divergence", float(np.median(rel)), 0.02))
    return out


def _pose_checks(contract, Ra, ta, na, Rb, tb, nb) -> list[Check]:
    return [
        Check(contract, "rotation max divergence", float(np.abs(Ra - Rb).max()), 1e-3),
        Check(contract, "translation max divergence m", float(np.abs(ta - tb).max()), 5e-3),
        Check(contract, "inlier count difference", float(abs(int(na) - int(nb))), 3),
    ]


def pose_opt_checks(device, ref) -> list[Check]:
    from ..backend.pose_opt import pose_optimize
    from ..geometry.camera import CameraIntrinsics

    rng = np.random.default_rng(7)
    cam = CameraIntrinsics(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=60.0,
                           width=320, height=240)
    n = 256
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 15, n)], -1).astype(np.float32)
    xc = pts + np.array([0.1, -0.05, 0.02], np.float32)
    obs = np.stack(
        [cam.fx * xc[:, 0] / xc[:, 2] + cam.cx,
         cam.fy * xc[:, 1] / xc[:, 2] + cam.cy,
         cam.fx * xc[:, 0] / xc[:, 2] + cam.cx - cam.bf / xc[:, 2]], -1,
    ).astype(np.float32)
    args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), pts, obs,
            np.zeros(n, np.int32), np.ones(n, bool), cam)
    a = _on(device, pose_optimize, *args)
    b = _on(ref, pose_optimize, *args)
    return _pose_checks("pose_optimize", a.R, a.t, a.n_inliers, b.R, b.t, b.n_inliers)


def track_step_checks(device, ref, cfg, scene) -> list[Check]:
    """Track a few frames on ``device`` (synchronous schedule), then run
    the next frame's track_step from identical inputs on both
    devices."""
    from ..data.synthetic import circular_trajectory
    from ..frontend.frame import build_stereo_frame
    from ..frontend.line_extractor import build_line_features
    from ..pipeline.track_step import track_step
    from ..pipeline.tracking import Tracker

    poses = circular_trajectory(6, step=0.25)
    frames = [scene.render_stereo(R, t) for R, t in poses]
    with jax.default_device(device):
        tracker = Tracker(cfg)
        tracker.pipeline_depth = 0
        tracker.async_mapping = False
        for i, (left, right) in enumerate(frames[:-1]):
            tracker.process_stereo(left, right, timestamp=0.1 * i)
        tracker.flush()
        left, right = (jnp.asarray(im) for im in frames[-1])
        frame = build_stereo_frame(left, right, cfg)
        lines = build_line_features(left, right, cfg.camera, cfg.lines)
        mir, last_frame, args = tracker._dispatch_inputs(tracker.cur_lines)
    has_lines = bool(mir["has_lines"])
    inputs = (frame, last_frame, mir["pt"], *args,
              lines if has_lines else None,
              mir["ln_start"], mir["ln_end"], mir["ln_desc"], mir["ln_valid"])
    inputs = jax.device_get(inputs)

    def run(*xs):
        return track_step(*xs, cfg=cfg, has_lines=has_lines)

    a = _on(device, run, *inputs)
    b = _on(ref, run, *inputs)
    checks = _pose_checks("track_step", a.R, a.t, a.packed[13], b.R, b.t, b.packed[13])
    checks.append(Check("track_step", "tracking ok on both", float(a.ok and b.ok), 1.0, upper=False))
    return checks


def run_parity(device, ref=None) -> list[Check]:
    """Every contract, ``device`` against the host CPU (or ``ref``)."""
    ref = ref if ref is not None else jax.devices("cpu")[0]
    cfg = kitti_config()
    scene = kitti_scene(cfg)
    iml, imr = scene.render_stereo(np.eye(3), np.zeros(3))
    return (
        frontend_checks(device, ref, cfg, iml, imr)
        + line_checks(device, ref, cfg, iml, imr)
        + pose_opt_checks(device, ref)
        + track_step_checks(device, ref, cfg, scene)
    )
