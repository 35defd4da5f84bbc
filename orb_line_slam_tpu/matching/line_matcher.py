"""Line matching: LBD Hamming + geometric gating, dense and masked.

Rebuilds the reference's LineMatcher / BinaryDescriptorMatcher usage
(src/LineMatcher.cc `[K]`, descriptor.hpp:1019-1090 — SURVEY.md §2.1
row 12): frame↔frame knn matching with angle/overlap/endpoint gates and
projection search of 3D map lines into the current frame.  Same
Hamming matmuls as points.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics, project
from ..geometry.se3 import se3_apply
from ..ops.hamming import hamming_matrix, knn2
from .point_matcher import Matches


def _angle_diff(a, b):
    return jnp.abs(((a - b + jnp.pi / 2) % jnp.pi) - jnp.pi / 2)


def match_lines(
    lf_a,
    lf_b,
    max_dist: int = 80,
    ratio: float = 0.85,
    ang_tol: float = 0.2,
    mid_radius: float = 60.0,
) -> Matches:
    """Frame-to-frame line matching (rows = lines of a)."""
    dist = hamming_matrix(lf_a.desc, lf_b.desc)
    dang = _angle_diff(lf_a.angle[:, None], lf_b.angle[None, :])
    mid_a = 0.5 * (lf_a.p0 + lf_a.p1)
    mid_b = 0.5 * (lf_b.p0 + lf_b.p1)
    dm = jnp.linalg.norm(mid_a[:, None] - mid_b[None, :], axis=-1)
    len_ratio = jnp.minimum(lf_a.length[:, None], lf_b.length[None, :]) / (
        jnp.maximum(lf_a.length[:, None], lf_b.length[None, :]) + 1e-6
    )
    gate = (
        (dang < ang_tol) & (dm < mid_radius) & (len_ratio > 0.5)
        & lf_b.valid[None, :]
    )
    idx, d1, d2 = knn2(dist, gate)
    ok = lf_a.valid & (d1 < max_dist) & (
        d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32)
    )
    return Matches(jnp.where(ok, idx, -1), d1, ok)


def search_lines_by_projection(
    start_w: jnp.ndarray,   # [M, 3] 3D start points (world)
    end_w: jnp.ndarray,     # [M, 3]
    desc_m: jnp.ndarray,    # [M, 32]
    valid_m: jnp.ndarray,   # [M]
    Rcw: jnp.ndarray,
    tcw: jnp.ndarray,
    lf,                     # frame LineFeatures
    cam: CameraIntrinsics,
    mid_radius: float = 40.0,
    ang_tol: float = 0.25,
    max_dist: int = 96,
    ratio: float = 0.9,
) -> Matches:
    """Project 3D map segments into the frame and match to 2D lines."""
    s_c = se3_apply(Rcw, tcw, start_w)
    e_c = se3_apply(Rcw, tcw, end_w)
    in_front = (s_c[:, 2] > 0.1) & (e_c[:, 2] > 0.1)
    s_uv = project(cam, s_c)
    e_uv = project(cam, e_c)
    mid = 0.5 * (s_uv + e_uv)
    in_img = (
        (mid[:, 0] >= 0) & (mid[:, 0] < cam.width)
        & (mid[:, 1] >= 0) & (mid[:, 1] < cam.height)
    )
    d = e_uv - s_uv
    ang = jnp.mod(jnp.arctan2(d[:, 1], d[:, 0]), jnp.pi)

    dist = hamming_matrix(desc_m, lf.desc)
    dang = _angle_diff(ang[:, None], lf.angle[None, :])
    mid_f = 0.5 * (lf.p0 + lf.p1)
    dm = jnp.linalg.norm(mid[:, None] - mid_f[None, :], axis=-1)
    gate = (dang < ang_tol) & (dm < mid_radius) & lf.valid[None, :]
    idx, d1, d2 = knn2(dist, gate)
    ok = (
        valid_m & in_front & in_img & (d1 < max_dist)
        & (d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32))
    )
    return Matches(jnp.where(ok, idx, -1), d1, ok)
