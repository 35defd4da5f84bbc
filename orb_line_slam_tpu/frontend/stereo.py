"""Stereo matching: row-band Hamming search + SAD sub-pixel refinement.

Static-shape JAX rebuild of Frame::ComputeStereoMatches (src/Frame.cc,
SURVEY.md §2.1 row 5, §3.2 "hot loop 3").  The reference loops over
left features, scanning row-compatible right candidates; here the whole
search is one masked [N, N] Hamming matrix (an int8 matmul) and the
SAD refinement is a batched window gather over the right pyramid
atlas:

  1. candidate mask = same row band (radius 2*scale of the right
     keypoint's octave) AND compatible octave (+-1, as the reference)
     AND disparity in (min_disp, max_disp);
  2. best Hamming match per left feature, gated at
     (TH_LOW+TH_HIGH)/2 = 75 as the reference, plus mutual-best and
     runner-up separation (see below);
  3. 11x11 center-normalized SAD over a +-5 px slide at the LEFT
     keypoint's pyramid level — the right window is re-sampled from the
     right image's same level (bilinear), exactly the reference's
     scaleduR0 convention — with parabola-fit sub-pixel minimum;
  4. median-deviation outlier rejection over SAD scores;
  5. depth = bf / disparity.

The mutual/separation gates (not in the reference) exist because a
single spurious near-depth match has ~fx/z leverage in pose
optimization: one z~1 m ghost from a wrong 174-px-disparity match was
measured to bias a whole frame pose by 0.16 m while passing every chi2
gate.  The full distance matrix is already on chip, so both gates are
free.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import OrbConfig
from ..geometry.camera import CameraIntrinsics
from ..ops.hamming import hamming_matrix, knn2

import os

SAD_W = 5       # half window -> 11x11
SAD_SLIDE = 5   # +-5 px slide
TH_STEREO = 75  # (TH_LOW + TH_HIGH)/2
# Runner-up separation margin: 0 = mutual-best only.  Measured on the
# synthetic out-and-back: a margin of 5 cuts ~10% of good depths and
# WORSENS ATE 4x (0.015 -> 0.059); the +-1-octave candidate fix plus the
# mutual gate is what kills ghost matches, not separation.
SEP_MARGIN = int(os.environ.get("OLS_STEREO_SEP", "0"))
CURVE_RATIO = float(os.environ.get("OLS_STEREO_CURVE", "0.8"))


class StereoMatch(NamedTuple):
    u_right: jnp.ndarray  # float32 [N]; -1 when unmatched
    depth: jnp.ndarray    # float32 [N]; -1 when unmatched


def _gather_window(atlas, cx, cy, half_w, extra=0):
    """Gather [N, 2h+1, 2h+1+2*extra] windows at float centers.

    One 32x32 integer-aligned tile per keypoint, then a 4-term bilinear
    blend of shifted tile views (elementwise) — replaces the
    1M-element gather of bilinear_sample.
    The tile center convention (keypoint at (15, 15)) caps the window at
    half_w + extra <= 10, which covers the 11x21 SAD strip.
    """
    from ..ops.brief import gather_patch_tiles

    assert half_w + extra <= 10
    xi = jnp.floor(cx)
    yi = jnp.floor(cy)
    fx = (cx - xi)[:, None, None]
    fy = (cy - yi)[:, None, None]
    xy = jnp.stack([xi, yi], axis=-1).astype(jnp.int32)
    t = gather_patch_tiles(atlas, xy)  # [N, 32, 32], center (15, 15)
    blend = (
        (1 - fy) * (1 - fx) * t[:, :-1, :-1]
        + (1 - fy) * fx * t[:, :-1, 1:]
        + fy * (1 - fx) * t[:, 1:, :-1]
        + fy * fx * t[:, 1:, 1:]
    )  # [N, 31, 31], center (15, 15)
    r0 = 15 - half_w
    c0 = 15 - half_w - extra
    return blend[:, r0 : r0 + 2 * half_w + 1, c0 : c0 + 2 * (half_w + extra) + 1]


def stereo_match(
    featL,
    featR,
    tilesL: jnp.ndarray,
    deltaL: jnp.ndarray,
    atlasR: jnp.ndarray,
    offsR: jnp.ndarray,
    cam: CameraIntrinsics,
    orb_cfg: OrbConfig,
) -> StereoMatch:
    """Stereo association.

    tilesL: [N, 32, 32] raw-image tiles at each left keypoint's own
    pyramid level, keypoint at tile index (15, 15) — produced by
    extract_orb_with_tiles.  atlasR/offsR: the right image's pyramid
    atlas and per-level row offsets; the SAD window is re-sampled from
    the LEFT keypoint's level of this atlas at the matched right
    keypoint's scaled column (reference Frame.cc: scaleduR0), which is
    what makes +-1-octave candidates legal.
    """
    scales = jnp.asarray(orb_cfg.level_scales, dtype=jnp.float32)
    uL, vL = featL.xy[:, 0], featL.xy[:, 1]
    uR, vR = featR.xy[:, 0], featR.xy[:, 1]
    octL, octR = featL.octave, featR.octave

    min_disp = 0.1
    # depth >= 2*baseline (reference allows depth >= baseline = fx max
    # disparity; the tighter bound cuts the highest-leverage ghost
    # depths — a z~2*b point has ~fx/z leverage on the pose — while true
    # points that close are out of frame in automotive/indoor data).
    max_disp = cam.bf / max(2.0 * cam.baseline, 1e-6)

    dist = hamming_matrix(featL.desc, featR.desc)
    band = 2.0 * scales[octR]
    row_ok = jnp.abs(vL[:, None] - vR[None, :]) <= band[None, :]
    # +-1 octave as the reference (ORBmatcher-style scale tolerance).
    # Equal-octave-only was measured to DROP the true match for ~2% of
    # features (detected one level off in the right image), leaving a
    # garbage candidate free to win the Hamming vote.
    oct_ok = jnp.abs(octL[:, None] - octR[None, :]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp > min_disp) & (disp < max_disp)
    valid = row_ok & oct_ok & disp_ok & featR.valid[None, :] & featL.valid[:, None]

    best_idx, best_d, second_d = knn2(dist, valid)
    big = jnp.int32(512)
    dist_m = jnp.where(valid, dist, big)
    col_best = jnp.argmin(dist_m, axis=0)  # best left row per right feature
    mutual = col_best[best_idx] == jnp.arange(dist.shape[0])
    separated = best_d + SEP_MARGIN <= second_d
    matched = (best_d < TH_STEREO) & mutual & separated

    # --- SAD sub-pixel refinement at the LEFT keypoint's level ---------
    # Integer-aligned windows on BOTH sides: bilinear resampling at a
    # fractional phase blurs one side more than the other, which biases
    # the SAD parabola ~0.04 px one-sided; integer alignment keeps the
    # residual pixel-locking bias symmetric (zero-mean over disparities).
    sc = scales[octL]
    uR0 = uR[best_idx]
    xr0 = jnp.floor(uR0 / sc)            # scaled right column (integer)
    yl = jnp.round(vL / sc)              # integer row at the left level
    cy = yl + offsR[octL].astype(jnp.float32)  # atlas row

    c = 15  # tile center index
    patchL = tilesL[:, c - SAD_W : c + SAD_W + 1, c - SAD_W : c + SAD_W + 1]
    patchL = patchL - patchL[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]

    stripR = _gather_window(atlasR, xr0, cy, SAD_W, extra=SAD_SLIDE)

    n_off = 2 * SAD_SLIDE + 1
    sads = []
    for k in range(n_off):
        win = jax.lax.dynamic_slice_in_dim(stripR, k, 2 * SAD_W + 1, axis=2)
        win = win - win[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append(jnp.sum(jnp.abs(patchL - win), axis=(1, 2)))
    sad = jnp.stack(sads, axis=1)  # [N, 11]

    best_k = jnp.argmin(sad, axis=1)
    ar = jnp.arange(sad.shape[0])
    s0 = sad[ar, jnp.clip(best_k - 1, 0, n_off - 1)]
    s1 = sad[ar, best_k]
    s2 = sad[ar, jnp.clip(best_k + 1, 0, n_off - 1)]
    denom = s0 + s2 - 2.0 * s1
    delta = jnp.where(jnp.abs(denom) > 1e-6, (s0 - s2) / (2.0 * denom), 0.0)
    interior = (best_k > 0) & (best_k < n_off - 1) & (jnp.abs(delta) <= 1.0)

    # Disparity anchored at the INTEGER left column the raw tile was
    # gathered at (xl_int = uL/sc - deltaL_x): the SAD localizes the
    # tile's content, which sits at the integer anchor, not at the
    # sub-pixel-refined uL.  Reporting u_right = uL - d keeps the
    # (uL, uR) observation pair consistent with the refined uL
    # (ADVICE r2 #2 — the mismatch injected up to +-0.5 px of
    # per-feature disparity error at the keypoint's level).
    xl_int = uL / sc - deltaL[:, 0]
    xr_m = xr0 + (best_k - SAD_SLIDE).astype(jnp.float32) + delta
    disparity = (xl_int - xr_m) * sc
    u_right = uL - disparity
    geom_ok = (disparity > min_disp) & (disparity < max_disp)

    # Median-deviation rejection over matched SAD scores (reference's
    # 1.5*1.4*median gate).
    s1_masked = jnp.where(matched, s1, jnp.nan)
    med = jnp.nanmedian(s1_masked)
    med = jnp.where(jnp.isnan(med), jnp.inf, med)
    sad_ok = s1 <= 2.1 * med

    # Distinct-minimum gate: a true correspondence has a sharp SAD
    # valley; a garbage pairing (similar texture, wrong place) is flat.
    # Require the center minimum to beat the slide edges by a margin.
    curve_ok = s1 <= CURVE_RATIO * jnp.minimum(sad[:, 0], sad[:, -1]) + 1e-3

    ok = matched & interior & geom_ok & sad_ok & curve_ok & featL.valid
    depth = jnp.where(ok, cam.bf / jnp.maximum(disparity, min_disp), -1.0)
    return StereoMatch(
        u_right=jnp.where(ok, u_right, -1.0),
        depth=depth,
    )
