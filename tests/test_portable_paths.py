"""CPU tests of the paths every backend shares: the patch-tile gather,
the fixed-point BRIEF sampler, the settings parser, the numpy scene
renderer, a System frame without OpenCV or PyYAML installed, and the
chip smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from orb_line_slam_tpu.config import _parse_opencv_yaml
from orb_line_slam_tpu.data import synthetic
from orb_line_slam_tpu.ops.brief import (
    N_ANGLE_BINS,
    brief_descriptors_from_tiles,
    brief_pattern,
    gather_patch_tiles,
)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "examples" / "configs").glob("*.yaml"))


# ---------------------------------------------------------------------------
# Patch-tile gather.
def _tiles_reference(img, xy):
    h, w = img.shape
    out = np.zeros((len(xy), 32, 32), np.float32)
    for i, (x, y) in enumerate(xy):
        x0 = min(max(x - 15, 0), w - 32)
        y0 = min(max(y - 15, 0), h - 32)
        out[i] = img[y0 : y0 + 32, x0 : x0 + 32]
    return out


@pytest.mark.parametrize(
    "where", ["interior", "top_left_border", "bottom_right_border"]
)
def test_patch_gather_matches_numpy(where):
    rng = np.random.default_rng(11)
    h, w = 96, 160
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if where == "interior":
        xy = np.stack([rng.integers(15, w - 17, 64), rng.integers(15, h - 17, 64)], -1)
    elif where == "top_left_border":
        xy = np.stack([rng.integers(0, 15, 64), rng.integers(0, 15, 64)], -1)
    else:
        xy = np.stack([rng.integers(w - 17, w, 64), rng.integers(h - 17, h, 64)], -1)
    xy = xy.astype(np.int32)
    got = np.asarray(gather_patch_tiles(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_array_equal(got, _tiles_reference(img.astype(np.float32), xy))
    if where == "interior":
        np.testing.assert_array_equal(got[:, 15, 15], img[xy[:, 1], xy[:, 0]])


# ---------------------------------------------------------------------------
# BRIEF: fixed-point sampling, bit for bit.
def _brief_reference(tiles, angles):
    """Rotate the pattern to each keypoint's quantized angle bin, sample
    the tile at the rounded points in 1/16 fixed point, pack LSB-first."""
    pat = brief_pattern().astype(np.float64)
    step = np.float32(2.0 * np.pi / N_ANGLE_BINS)
    bins = np.mod(np.round(angles.astype(np.float32) / step).astype(np.int64), N_ANGLE_BINS)
    tf = np.round(tiles * np.float32(16.0)).astype(np.int64)
    out = np.zeros((len(tiles), 32), np.uint8)
    for i, b in enumerate(bins):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        samples = []
        for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
            rx = np.round(c * px - s * py).astype(np.int64)
            ry = np.round(s * px + c * py).astype(np.int64)
            samples.append(tf[i, np.clip(15 + ry, 0, 31), np.clip(15 + rx, 0, 31)])
        bits = (samples[1] > samples[0]).astype(np.uint8)
        out[i] = np.packbits(bits.reshape(32, 8), axis=1, bitorder="little")[:, 0]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_brief_matches_fixed_point_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    # Blurred-tile-like values with fractional parts, all 30 angle bins.
    tiles = rng.uniform(0, 255, (n, 32, 32)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    got = np.asarray(brief_descriptors_from_tiles(jnp.asarray(tiles), jnp.asarray(angles)))
    np.testing.assert_array_equal(got, _brief_reference(tiles, angles))


# ---------------------------------------------------------------------------
# Settings parser: the shipped cv::FileStorage files, against PyYAML.
@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_settings_parser_matches_yaml(path):
    yaml = pytest.importorskip("yaml")
    import re

    text = path.read_text()
    ref = yaml.safe_load(
        re.sub(r"^%YAML:.*$", "", text, flags=re.M).replace("!!opencv-matrix", "")
    )
    got = _parse_opencv_yaml(text)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(
                got[k], np.array(v["data"], np.float64).reshape(v["rows"], v["cols"])
            )
        else:
            assert got[k] == v and type(got[k]) is type(v), k


# ---------------------------------------------------------------------------
# Renderer helpers against the OpenCV calls they replace.
@pytest.mark.parametrize("op", ["resize_linear", "resize_area", "warp", "line"])
def test_renderer_matches_opencv(op):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    if op == "resize_linear":
        for g in (4, 8, 16, 32):
            grids = rng.uniform(-1, 1, (20, g, g)).astype(np.float32)
            ref = np.stack([cv2.resize(x, (64, 64), interpolation=cv2.INTER_LINEAR) for x in grids])
            np.testing.assert_allclose(synthetic._resize_linear(grids, 64), ref, atol=1e-6)
    elif op == "resize_area":
        patches = rng.integers(0, 256, (50, 64, 64)).astype(np.uint8)
        for s in (32, 16, 8, 4):
            ref = np.stack([cv2.resize(p, (s, s), interpolation=cv2.INTER_AREA) for p in patches])
            np.testing.assert_array_equal(synthetic._resize_area(patches, s), ref)
    elif op == "warp":
        for trial in range(40):
            n = (64, 32, 16, 8, 4)[trial % 5]
            patch = rng.integers(0, 256, (n, n)).astype(np.float32)
            s = rng.uniform(3, 70)
            tx, ty = rng.uniform(-2, 2, 2)
            w, h = int(np.ceil(s)) + 3, int(np.ceil(s)) + 2
            M = np.array([[s / n, 0, tx], [0, s / n, ty]])
            ref = cv2.warpAffine(patch, M, (w, h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0)
            got = synthetic._warp_scaled(patch, s / n, tx, ty, w, h)
            # OpenCV's vectorized float path rounds coordinates differently
            # in the last bits: ~1e-3 gray levels.
            np.testing.assert_allclose(got, ref, atol=5e-3)
    else:
        inter = union = 0
        for _ in range(200):
            p0 = tuple(int(v) for v in rng.integers(-50, 400, 2))
            p1 = tuple(int(v) for v in rng.integers(-50, 400, 2))
            a = np.full((240, 320), 110, np.uint8)
            b = a.copy()
            cv2.line(a, p0, p1, 30, 2, cv2.LINE_8)
            synthetic._thick_line(b, p0, p1, 30)
            inter += ((a == 30) & (b == 30)).sum()
            union += ((a == 30) | (b == 30)).sum()
        # Same polygon fill and caps; the one-pixel outline steps differ.
        assert inter / union > 0.85


# ---------------------------------------------------------------------------
# The main path imports neither OpenCV nor PyYAML.
_NO_CV2_SCRIPT = r"""
import dataclasses, sys
sys.modules["cv2"] = None
sys.modules["yaml"] = None
import numpy as np
from orb_line_slam_tpu.config import LineConfig, OrbConfig, load_settings
from orb_line_slam_tpu.data.synthetic import SyntheticScene
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.pipeline.system import System

cfg = load_settings(sys.argv[1])
assert cfg.camera.width == 1241 and cfg.orb.n_features == 2000
cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0,
                       width=640, height=320)
cfg = dataclasses.replace(cfg, camera=cam, orb=OrbConfig(n_features=500, n_levels=4),
                          lines=LineConfig(n_lines=32))
scene = SyntheticScene(cam, n_points=400, seed=3)
sysm = System(cfg, use_loop_closing=False)
Tcw = sysm.track_stereo(*scene.render_stereo(np.eye(3), np.zeros(3)), timestamp=0.0)
assert np.asarray(Tcw).shape == (4, 4) and np.isfinite(Tcw).all()
assert sysm.tracking_state() == "OK", sysm.tracking_state()
print("NO_CV2_OK")
"""


def test_system_frame_without_opencv_or_yaml():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_CV2_SCRIPT, str(REPO / "examples" / "configs" / "KITTI00-02.yaml")],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO),
    )
    assert "NO_CV2_OK" in proc.stdout, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to run without a GPU and prints no result.
@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, env=env, cwd=str(script.parent),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
