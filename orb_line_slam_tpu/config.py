"""Typed configuration + loader for the reference's YAML settings files.

The reference parses per-dataset YAML with cv::FileStorage
(src/Tracking.cc ctor; SURVEY.md §5 "Config / flag system") with keys
like ``Camera.fx``, ``ORBextractor.nFeatures``, ``ThDepth`` and EuRoC
stereo-rectification blocks ``LEFT.*/RIGHT.*``.  ``load_settings``
accepts those files verbatim (capability parity), and files of our own
written in the same subset.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np

from .geometry.camera import CameraIntrinsics


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 32
    edge_margin: int = 19

    @property
    def level_scales(self) -> tuple[float, ...]:
        return tuple(self.scale_factor**i for i in range(self.n_levels))

    @property
    def level_quotas(self) -> tuple[int, ...]:
        """Per-level feature budget; geometric decay as ORBextractor's
        nDesiredFeaturesPerScale (sums exactly to n_features)."""
        inv = 1.0 / self.scale_factor
        n0 = self.n_features * (1.0 - inv) / (1.0 - inv**self.n_levels)
        quotas = [int(round(n0 * inv**i)) for i in range(self.n_levels)]
        quotas[0] += self.n_features - sum(quotas)
        return tuple(quotas)


@dataclasses.dataclass(frozen=True)
class LineConfig:
    enabled: bool = True
    n_lines: int = 128
    min_length_frac: float = 0.03  # min segment length as fraction of image diag
    n_bands: int = 9
    band_width: int = 7


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    th_depth: float = 35.0  # close/far stereo point threshold, x baseline
    max_frames_between_kf: int = 30  # ~1s at 30fps; reset from fps at load
    min_frames_between_kf: int = 0
    motion_search_radius: float = 15.0
    local_map_search_radius: float = 3.0
    min_inliers_ok: int = 30
    min_inliers_reloc: int = 50


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Capacity bounds for the SoA map store (static shapes)."""

    max_keyframes: int = 512
    max_points: int = 65536
    max_lines: int = 4096
    max_obs_per_kf: int = 2048  # = points per frame budget
    local_window: int = 16  # free KFs in local BA
    local_points: int = 8192  # landmark budget in local BA


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraIntrinsics = CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
        width=1241, height=376,
    )
    orb: OrbConfig = OrbConfig()
    lines: LineConfig = LineConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    fps: float = 10.0
    rgb: bool = False
    # TUM-style uint16 depth PNG scale (depth_m = raw / factor).
    depth_map_factor: float = 5000.0
    # EuRoC-style rectification (None for pre-rectified datasets).
    rectify: Optional[dict] = None


def _scalar(text: str) -> Any:
    """A YAML plain scalar: int, float, or the string itself."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text.strip("'\"")


def _parse_opencv_yaml(text: str) -> dict[str, Any]:
    """Parse cv::FileStorage YAML (the reference's settings format).

    Handles the subset the settings files use: the %YAML:1.0 directive,
    ``#`` comments, scalar ``Key.sub: value`` entries and
    ``!!opencv-matrix`` nodes (indented rows/cols/dt and a flow-sequence
    ``data`` that may span several lines).
    """
    out: dict[str, Any] = {}
    matrix: Optional[dict] = None
    key = None
    data_buf: Optional[str] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.startswith("%"):
            continue
        if data_buf is not None:  # continuation of a multi-line data: [...]
            data_buf += " " + line.strip()
        else:
            k, sep, v = line.strip().partition(":")
            if not sep:
                raise ValueError(f"malformed settings line: {raw!r}")
            k, v = k.strip(), v.strip()
            if matrix is not None and raw[:1].isspace():
                if k != "data":
                    matrix[k] = _scalar(v)
                    continue
                data_buf = v
            else:
                matrix = None
                if v == "!!opencv-matrix":
                    matrix, key = {}, k
                else:
                    out[k] = _scalar(v)
                continue
        if data_buf.endswith("]"):
            vals = [float(x) for x in data_buf.strip("[]").split(",") if x.strip()]
            out[key] = np.array(vals, dtype=np.float64).reshape(
                int(matrix["rows"]), int(matrix["cols"])
            )
            data_buf = None
    if data_buf is not None:
        raise ValueError(f"unterminated matrix data for {key!r}")
    return out


def load_settings(path: str | Path) -> SlamConfig:
    """Load a reference-format YAML settings file into a SlamConfig."""
    raw = _parse_opencv_yaml(Path(path).read_text())

    def get(key, default):
        return raw.get(key, default)

    cam = CameraIntrinsics(
        fx=float(get("Camera.fx", 0.0)),
        fy=float(get("Camera.fy", 0.0)),
        cx=float(get("Camera.cx", 0.0)),
        cy=float(get("Camera.cy", 0.0)),
        bf=float(get("Camera.bf", 0.0)),
        k1=float(get("Camera.k1", 0.0)),
        k2=float(get("Camera.k2", 0.0)),
        p1=float(get("Camera.p1", 0.0)),
        p2=float(get("Camera.p2", 0.0)),
        k3=float(get("Camera.k3", 0.0)),
        width=int(get("Camera.width", get("Camera.cols", 0))),
        height=int(get("Camera.height", get("Camera.rows", 0))),
    )
    orb = OrbConfig(
        n_features=int(get("ORBextractor.nFeatures", 2000)),
        scale_factor=float(get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th_fast=float(get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(get("ORBextractor.minThFAST", 7)),
    )
    fps = float(get("Camera.fps", 10.0))
    baseline = cam.bf / cam.fx if cam.fx else 0.0
    tracking = TrackingConfig(
        th_depth=float(get("ThDepth", 35.0)),
        max_frames_between_kf=max(1, int(round(fps))),
    )
    rectify = None
    if "LEFT.K" in raw:
        rectify = {
            side: {
                "K": raw[f"{side}.K"],
                "D": raw[f"{side}.D"],
                "R": raw[f"{side}.R"],
                "P": raw[f"{side}.P"],
                "height": int(raw[f"{side}.height"]),
                "width": int(raw[f"{side}.width"]),
            }
            for side in ("LEFT", "RIGHT")
        }
        if cam.width == 0:
            cam = cam._replace(
                width=rectify["LEFT"]["width"], height=rectify["LEFT"]["height"]
            )
    return SlamConfig(
        camera=cam,
        orb=orb,
        tracking=tracking,
        fps=fps,
        rgb=bool(get("Camera.RGB", 0)),
        depth_map_factor=float(get("DepthMapFactor", 5000.0)),
        rectify=rectify,
    )
