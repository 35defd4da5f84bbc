"""Point matching as dense masked Hamming matrices.

Static-shape JAX rebuild of ORBmatcher (src/ORBmatcher.cc, SURVEY.md §2.1
row 11).  The reference accelerates candidate lookup with a 64x48
feature grid and BoW FeatureVector node pruning — CPU tricks to shrink
the candidate set.  On an accelerator the full [M, N] descriptor-distance
matrix is one int8 matmul, so every search variant becomes: distance matrix
+ geometric validity mask + (best, second-best) selection + ratio test
+ rotation-consistency histogram.  Thresholds mirror the reference:
TH_LOW=50, TH_HIGH=100, ratio 0.6-0.9, 30-bin rotation histogram with
top-3 bins kept.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics, project_stereo
from ..geometry.se3 import se3_apply
from ..ops.hamming import TH_HIGH, TH_LOW, hamming_matrix, knn2

_HI = jax.lax.Precision.HIGHEST  # small-K geometry: bf16-unsafe

HISTO_BINS = 30


class Matches(NamedTuple):
    """Per-row match into the 'other' set; -1 where unmatched."""

    idx: jnp.ndarray   # int32 [M]
    dist: jnp.ndarray  # int32 [M]
    mask: jnp.ndarray  # bool [M]


@jax.jit
def rotation_consistency(
    angle_a: jnp.ndarray, angle_b_matched: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram bins (ORBmatcher::ComputeThreeMaxima)."""
    diff = (angle_a - angle_b_matched) * (180.0 / jnp.pi)
    diff = jnp.mod(diff, 360.0)
    bins = jnp.clip((diff * HISTO_BINS / 360.0).astype(jnp.int32), 0, HISTO_BINS - 1)
    counts = jnp.sum(
        jax.nn.one_hot(bins, HISTO_BINS, dtype=jnp.int32) * mask[:, None].astype(jnp.int32),
        axis=0,
    )
    top3 = jax.lax.top_k(counts, 3)[0]
    # A bin survives if it is one of the three largest AND holds at least
    # 10% of the best bin's votes (ComputeThreeMaxima's 0.1*max rule).
    good_bin = (counts >= top3[2]) & (counts * 10 >= top3[0]) & (counts > 0)
    return mask & good_bin[bins]


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio"))
def match_descriptors(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    extra_mask: jnp.ndarray | None = None,
) -> Matches:
    """Brute-force descriptor matching with best/second ratio test
    (SearchByBoW semantics without the node pruning)."""
    dist = hamming_matrix(desc_a, desc_b)
    cols = valid_b[None, :]
    if extra_mask is not None:
        cols = cols & extra_mask
    idx, d1, d2 = knn2(dist, cols)
    ok = valid_a & (d1 < max_dist) & (d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32))
    return Matches(jnp.where(ok, idx, -1), d1, ok)


def predict_scale(
    dist: jnp.ndarray, max_dist_p: jnp.ndarray, n_levels: int, scale_factor: float
) -> jnp.ndarray:
    """Expected pyramid octave of a landmark at viewing distance `dist`
    (MapPoint::PredictScale): octave = ceil(log(maxDist/dist)/log(s))."""
    ratio = jnp.maximum(max_dist_p, 1e-6) / jnp.maximum(dist, 1e-6)
    oct_f = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor))
    return jnp.clip(oct_f, 0, n_levels - 1).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "level_scales", "radius", "max_dist", "ratio", "check_ur",
        "oct_tol",
    ),
)
def search_by_projection(
    points_w: jnp.ndarray,
    desc_p: jnp.ndarray,
    valid_p: jnp.ndarray,
    octave_p: jnp.ndarray,
    Rcw: jnp.ndarray,
    tcw: jnp.ndarray,
    frame,
    cam: CameraIntrinsics,
    level_scales,
    radius: float,
    max_dist: int = TH_HIGH,
    ratio: float = 1.0,
    check_ur: bool = False,
    max_dist_p: jnp.ndarray | None = None,
    min_dist_p: jnp.ndarray | None = None,
    normal_p: jnp.ndarray | None = None,
    oct_tol: int = 1,
) -> Matches:
    """Project world landmarks into a frame and match within a windowed
    radius (SearchByProjection, the motion-model / local-map variants).

    Args:
      points_w: float32 [M, 3] landmark positions.
      desc_p / valid_p / octave_p: landmark descriptor state.
      Rcw, tcw: candidate camera pose.
      frame: Frame (xy, desc, octave, valid, u_right).
      radius: base search radius in pixels, scaled by the landmark's
        (predicted) pyramid level as the reference does.
      max_dist_p/min_dist_p: scale-invariance distance range; when given,
        the expected octave is PREDICTED from viewing distance
        (MapPoint::PredictScale) instead of using the creation octave,
        and out-of-range landmarks are rejected (Frame::isInFrustum).
      normal_p: mean viewing normals; gates view angle < 60 deg.
    Returns per-landmark Matches into frame keypoints.
    """
    scales = jnp.asarray(level_scales, dtype=jnp.float32)
    n_levels = len(level_scales)
    scale_factor = float(level_scales[1] / level_scales[0]) if n_levels > 1 else 1.2
    xc = se3_apply(Rcw, tcw, points_w)
    obs = project_stereo(cam, xc)  # [M, 3] (u, v, uR)
    in_front = xc[:, 2] > 0.1
    in_img = (
        (obs[:, 0] >= 0) & (obs[:, 0] < cam.width)
        & (obs[:, 1] >= 0) & (obs[:, 1] < cam.height)
    )
    dist_ok = jnp.ones_like(in_front)
    view_ok = jnp.ones_like(in_front)
    if max_dist_p is not None:
        cam_center = -jnp.einsum("ji,j->i", Rcw, tcw, precision=_HI)
        view = points_w - cam_center
        dist = jnp.linalg.norm(view, axis=-1)
        octave_p = predict_scale(dist, max_dist_p, n_levels, scale_factor)
        if min_dist_p is not None:
            dist_ok = (dist >= 0.8 * min_dist_p) & (dist <= 1.2 * max_dist_p)
        if normal_p is not None:
            cosang = jnp.sum(view * normal_p, axis=-1) / jnp.maximum(dist, 1e-6)
            view_ok = cosang > 0.5
    r = radius * scales[jnp.clip(octave_p, 0, n_levels - 1)]

    du = obs[:, 0:1] - frame.xy[None, :, 0]
    dv = obs[:, 1:2] - frame.xy[None, :, 1]
    close = (du * du + dv * dv) <= (r * r)[:, None]
    # Octave gate: frame keypoint level within +-oct_tol of the
    # (predicted) landmark level.
    oct_ok = jnp.abs(frame.octave[None, :] - octave_p[:, None]) <= oct_tol
    # Stereo-consistency gate on u_right when the frame has depth.
    if check_ur:
        dur = jnp.abs(obs[:, 2:3] - frame.u_right[None, :])
        ur_ok = (frame.u_right[None, :] < 0) | (dur <= r[:, None])
    else:
        ur_ok = jnp.ones_like(close)

    col_mask = close & oct_ok & ur_ok & frame.valid[None, :]
    dist = hamming_matrix(desc_p, frame.desc)
    idx, d1, d2 = knn2(dist, col_mask)
    ok = (
        valid_p
        & in_front
        & in_img
        & dist_ok
        & view_ok
        & (d1 < max_dist)
        & (d1.astype(jnp.float32) <= ratio * d2.astype(jnp.float32))
    )
    return Matches(jnp.where(ok, idx, -1), d1, ok)


@functools.partial(
    jax.jit, static_argnames=("cam", "level_scales", "radius", "max_dist")
)
def search_by_sim3_dir(
    pts_in_dst: jnp.ndarray,   # [M, 3] source landmarks in DEST camera frame
    desc_src: jnp.ndarray,     # [M, 32]
    valid_src: jnp.ndarray,    # [M]
    xy_dst: jnp.ndarray,       # [N, 2] dest keypoints
    desc_dst: jnp.ndarray,     # [N, 32]
    oct_dst: jnp.ndarray,      # [N]
    valid_dst: jnp.ndarray,    # [N]
    cam: CameraIntrinsics,
    level_scales,
    radius: float = 7.5,
    max_dist: int = TH_HIGH,
) -> Matches:
    """One direction of ORBmatcher::SearchBySim3: project the source
    keyframe's landmarks (already transformed by the current Sim3 into
    the destination camera frame) and match within a per-keypoint
    scale-adapted pixel window, Hamming <= TH_HIGH, no ratio test —
    exactly the reference's guided-match semantics.  The caller runs
    both directions and keeps mutually-consistent pairs."""
    from ..geometry.camera import project

    scales = jnp.asarray(level_scales, dtype=jnp.float32)
    uv = project(cam, pts_in_dst)
    z = pts_in_dst[:, 2]
    ok_src = (
        valid_src
        & (z > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    du = uv[:, 0:1] - xy_dst[None, :, 0]
    dv = uv[:, 1:2] - xy_dst[None, :, 1]
    r = radius * scales[jnp.clip(oct_dst, 0, len(level_scales) - 1)]
    close = (du * du + dv * dv) <= (r * r)[None, :]
    dist = hamming_matrix(desc_src, desc_dst)
    idx, d1, _ = knn2(dist, close & valid_dst[None, :])
    ok = ok_src & (d1 <= max_dist)
    return Matches(jnp.where(ok, idx, -1), d1, ok)


@functools.partial(jax.jit, static_argnames=("n_targets",))
def resolve_duplicates(matches: Matches, n_targets: int) -> Matches:
    """Keep only the lowest-distance landmark per frame keypoint (the
    reference replaces an existing match if a closer one arrives)."""
    # scatter-min of dist onto targets
    big = jnp.int32(1 << 20)
    tgt = jnp.where(matches.mask, matches.idx, n_targets)  # overflow row = dump
    best = jnp.full((n_targets + 1,), big, dtype=jnp.int32).at[tgt].min(matches.dist)
    keep = matches.mask & (matches.dist <= best[tgt])
    # Tie-break double winners: keep the first row claiming the target.
    order = jnp.arange(matches.idx.shape[0], dtype=jnp.int32)
    first = (
        jnp.full((n_targets + 1,), 1 << 20, dtype=jnp.int32)
        .at[jnp.where(keep, tgt, n_targets)]
        .min(order)
    )
    keep = keep & (first[tgt] == order)
    return Matches(jnp.where(keep, matches.idx, -1), matches.dist, keep)


@functools.partial(jax.jit, static_argnames=("radius", "max_dist", "ratio"))
def match_in_window(
    frame_a,
    frame_b,
    radius: float = 100.0,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
) -> Matches:
    """Frame-to-frame matching windowed around each keypoint's own
    location (SearchForInitialization: the spatial window keeps the
    ratio test from drowning in far-away confusers)."""
    dist = hamming_matrix(frame_a.desc, frame_b.desc)
    du = frame_a.xy[:, 0:1] - frame_b.xy[None, :, 0]
    dv = frame_a.xy[:, 1:2] - frame_b.xy[None, :, 1]
    close = (du * du + dv * dv) <= radius * radius
    idx, d1, d2 = knn2(dist, close & frame_b.valid[None, :])
    ok = (
        frame_a.valid
        & (d1 < max_dist)
        & (d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32))
    )
    return Matches(jnp.where(ok, idx, -1), d1, ok)
