"""Line-segment detection as batched dense stencils.

Replaces the vendored LSD detector (Thirdparty/line_descriptor
LSDDetector — SURVEY.md §2.2, §7.2 hard-part #1).  LSD's greedy
region-growing is inherently sequential, so this is a redesign with the
same contract (oriented segments with endpoints, angle, response):

  1. Sobel gradients -> magnitude + level-line doubled-angle fields
     (banded-matmul stencils, ops/image.py).
  2. Coherence score: Gaussian-blurred edge-masked (cos 2θ, sin 2θ);
     its magnitude is high exactly where neighbouring edge pixels share
     one line direction (texture cancels, straight edges add).  This
     replaces an earlier 12-direction rolled correlation that cost
     ~200 full-image ops with two blurs.
  3. Candidate centers: per-cell top-K of the score
     (reusing the keypoint distribution machinery).
  4. Endpoint walk, batched: for each candidate, sample the fused
     (edge, cos2θ, sin2θ) field — ONE 3-channel gather per step batch —
     along +-L steps of its direction; the segment extent is the
     prefix run length with gap tolerance — a masked cumsum, no
     data-dependent loops.
  5. Least-squares refit: endpoints snapped to the support centroid
     line; response = supported length.

Output is padded [L_max] with a validity mask, like every other stage.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .image import bilinear_sample, gaussian_blur, sobel_gradients


def _nearest_sample(img, xy):
    """Nearest-neighbour multi-channel sample: ONE gather instead of
    bilinear's four.  The endpoint walk only thresholds the sampled
    fields (edge > 0.25, angle cone), so sub-pixel interpolation buys
    nothing there — measured 4x cheaper on the gather-bound walk."""
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, -1) if img.ndim == 3 else img.reshape(-1)
    x = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, h - 1)
    return jnp.take(flat, y * w + x, axis=0)

WALK_STEPS = 80      # walk samples per direction (x WALK_STRIDE px reach)
WALK_STRIDE = 2.0    # px between walk samples: the sub-pixel refit below
                     # recovers endpoint accuracy, so sampling every
                     # other pixel halves the gather cost for ~zero
                     # detection-quality change (parity tests unchanged)
GAP_TOL = 2          # tolerated consecutive support gaps (in samples)


class DetectedLines(NamedTuple):
    p0: jnp.ndarray       # float32 [L, 2] endpoint (x, y)
    p1: jnp.ndarray       # float32 [L, 2] endpoint
    angle: jnp.ndarray    # float32 [L] direction in [0, pi)
    length: jnp.ndarray   # float32 [L]
    response: jnp.ndarray  # float32 [L] supported length
    valid: jnp.ndarray    # bool [L]


@functools.partial(jax.jit, static_argnames=("n_lines", "min_mag", "cell"))
def detect_lines(
    img: jnp.ndarray,
    n_lines: int = 128,
    min_mag: float = 30.0,
    cell: int = 24,
    grads=None,
) -> DetectedLines:
    """Detect up to n_lines segments in a 2D float/uint8 image.

    grads: optional precomputed (gx, gy) Sobel pair — lets the caller
    share one gradient pass with the LBD stage."""
    x = img.astype(jnp.float32)
    gx, gy = sobel_gradients(x) if grads is None else grads
    mag2 = gx * gx + gy * gy
    # Zero the border: stencil zero-padding fabricates huge step edges there.
    hh, ww = x.shape
    ys = jnp.arange(hh)[:, None]
    xs = jnp.arange(ww)[None, :]
    interior = (ys >= 4) & (ys < hh - 4) & (xs >= 4) & (xs < ww - 4)
    mag2 = jnp.where(interior, mag2, 0.0)
    mag = jnp.sqrt(mag2)
    edge = (mag2 > min_mag * min_mag).astype(jnp.float32)

    # Level-line doubled angle (direction ALONG the edge = gradient
    # direction + pi/2, so 2θ_ll = 2θ_grad + pi): unit (cos, sin) pair,
    # masked to edge pixels.
    inv = edge / jnp.maximum(mag2, 1e-9)
    c2 = -(gx * gx - gy * gy) * inv
    s2 = -(2.0 * gx * gy) * inv

    # Coherence fields: blurred doubled-angle vectors.  |(c2b, s2b)| is
    # the edge density times the local angular coherence — texture and
    # corners cancel, straight supported edges score ~0.2 (the 1D
    # Gaussian center weight) regardless of direction.
    c2b = gaussian_blur(c2, sigma=2.0, radius=4)
    s2b = gaussian_blur(s2, sigma=2.0, radius=4)
    score = edge * jnp.sqrt(c2b * c2b + s2b * s2b)

    h, w = x.shape
    from .topk_grid import select_topk_grid

    xy, resp, valid = select_topk_grid(score, cell, 2, n_lines, 0.06)

    # Sub-bin direction at the candidate from the smoothed fields.
    c2p = c2b[xy[:, 1], xy[:, 0]]
    s2p = s2b[xy[:, 1], xy[:, 0]]
    theta = jnp.mod(0.5 * jnp.arctan2(s2p, c2p), jnp.pi)

    # Batched endpoint walk on the fused (edge, cos2θ, sin2θ) field:
    # ONE 3-channel gather per walk instead of three scalar gathers.
    field = jnp.stack([edge, c2, s2], axis=-1)  # [H, W, 3]
    steps = WALK_STRIDE * jnp.arange(1, WALK_STEPS + 1, dtype=jnp.float32)
    centers = xy.astype(jnp.float32)

    def walk(direction_sign, theta, dxy):
        pts = centers[:, None, :] + direction_sign * dxy[:, None, :] * steps[None, :, None]
        s = _nearest_sample(field, pts)              # [L, S, 3]
        e = s[..., 0] > 0.25
        # Angle gate, normalized: cos(2(angle-theta)) > 0.5 = within
        # pi/6 of theta.  Normalizing by the sampled magnitude removes
        # the edge-mask scaling; the tight tolerance is what kills
        # walks that hop across curved structures (dot rims, corners)
        # whose tangents drift away from the chord direction.
        nrm2 = jnp.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) + 1e-6
        cos2 = (
            s[..., 1] * jnp.cos(2 * theta)[:, None]
            + s[..., 2] * jnp.sin(2 * theta)[:, None]
        ) / nrm2
        good = e & (cos2 > 0.5)
        # Gap-tolerant run length: the walk dies at the first window of
        # GAP_TOL+1 consecutive misses.  Closed form (no scan — a scan
        # of 160 tiny sequential kernels wastes the VPU): a window of
        # w misses ends at step s iff miss[s] & miss[s-1] & ... &
        # miss[s-w+1], i.e. an AND of GAP_TOL+1 shifted copies.
        miss = ~good
        run = miss
        for sft in range(1, GAP_TOL + 1):
            run = run & jnp.pad(miss, ((0, 0), (sft, 0)))[:, : miss.shape[1]]
        dead = jnp.cumsum(run.astype(jnp.int32), axis=1) > 0
        alive = ~dead
        ga = good & alive
        # Extent ends at the LAST SUPPORTED step, not at walk death —
        # otherwise every segment grows GAP_TOL px of unsupported tail,
        # which tilts the endpoint refit below.
        extent = jnp.max(jnp.where(ga, steps[None, :], 0.0), axis=1)
        # supported length in px (each sample stands for WALK_STRIDE px)
        supported = WALK_STRIDE * jnp.sum(ga.astype(jnp.float32), axis=1)
        return extent, supported

    def both_walks(theta):
        dxy = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
        ext_p, sup_p = walk(+1.0, theta, dxy)
        ext_m, sup_m = walk(-1.0, theta, dxy)
        p0 = centers - dxy * ext_m[:, None]
        p1 = centers + dxy * ext_p[:, None]
        return p0, p1, ext_p + ext_m, sup_p + sup_m + 1.0

    # First pass with the local direction, then refit the direction from
    # the recovered endpoints and walk once more (long, slightly curved
    # or mis-angled supports converge to the true chord).
    p0, p1, _, _ = both_walks(theta)
    d01 = p1 - p0
    theta = jnp.mod(jnp.arctan2(d01[:, 1], d01[:, 0]), jnp.pi)
    p0, p1, length, supported = both_walks(theta)

    # Longitudinal endpoint polish: the stride-2 walk localizes each
    # endpoint only to ~WALK_STRIDE px; resample the support at 0.5 px
    # along the direction and pull the endpoint to the last contiguous
    # supported offset (the stereo-disparity path downstream is
    # sensitive to ~1 px of endpoint overshoot).
    polish_off = jnp.arange(-6, 7, dtype=jnp.float32) * 0.5  # [-3, +3] px

    def polish(p, outward):
        pts = p[:, None, :] + outward[:, None, :] * polish_off[None, :, None]
        s = bilinear_sample(field, pts)                        # [L, 13, 3]
        # (bilinear here: the polish IS the sub-pixel stage)
        nrm2 = jnp.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) + 1e-6
        cos2 = (
            s[..., 1] * jnp.cos(2 * theta)[:, None]
            + s[..., 2] * jnp.sin(2 * theta)[:, None]
        ) / nrm2
        good = (s[..., 0] > 0.25) & (cos2 > 0.5)
        n_ok = jnp.sum(jnp.cumprod(good.astype(jnp.int32), axis=1), axis=1)
        off = polish_off[jnp.clip(n_ok - 1, 0, polish_off.shape[0] - 1)]
        off = jnp.where(n_ok > 0, off, 0.0)
        return p + outward * off[:, None]

    dxy = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    p0 = polish(p0, -dxy)
    p1 = polish(p1, dxy)

    # Sub-pixel refinement: least-squares refit of the chord through the
    # magnitude-weighted perpendicular support centroids — corrects BOTH
    # the lateral offset and the residual angle error of the walk (a
    # mean-shift alone leaves ~0.5 deg of tilt = px-level endpoint error
    # on 150 px segments, which the stereo disparity path amplifies).
    # One GATHER pass over a wide perpendicular window, then the
    # iteration runs arithmetically on the fixed samples: each round
    # re-centres a triangular weight window on the current fit line and
    # refits — equivalent to the old resample-per-round scheme for the
    # <=3 px corrections the walk leaves, at 1/3 the gather cost (the
    # three bilinear resamples were ~2 ms/image of the 4.1 ms detector).
    ts_ref = jnp.linspace(0.02, 0.98, 32)
    perp_off = jnp.arange(-4, 5, dtype=jnp.float32)

    def refit(p0, p1, n_rounds=3):
        d01 = p1 - p0
        th = jnp.arctan2(d01[:, 1], d01[:, 0])
        nrm = jnp.stack([-jnp.sin(th), jnp.cos(th)], axis=-1)
        base = p0[:, None, :] + d01[:, None, :] * ts_ref[None, :, None]
        samp = (
            base[:, :, None, :]
            + nrm[:, None, None, :] * perp_off[None, None, :, None]
        )                                                                 # [L,32,9,2]
        wmag = bilinear_sample(mag, samp)                                 # [L,32,9]
        a_fit = jnp.zeros(p0.shape[0])
        b_fit = jnp.zeros(p0.shape[0])
        for _ in range(n_rounds):
            # Triangular window centred on the current fit line keeps
            # far-off structure from dragging the centroid.
            line_off = a_fit[:, None] + b_fit[:, None] * ts_ref[None, :]
            dist = jnp.abs(perp_off[None, None, :] - line_off[:, :, None])
            wm = wmag * jnp.maximum(1.0 - dist / 3.0, 0.0)
            wsum = jnp.sum(wm, axis=2)
            woff = jnp.sum(wm * perp_off[None, None, :], axis=2) / (wsum + 1e-6)
            wn = wsum / (jnp.sum(wsum, axis=1, keepdims=True) + 1e-6)
            tbar = jnp.sum(wn * ts_ref[None, :], axis=1)
            obar = jnp.sum(wn * woff, axis=1)
            tc = ts_ref[None, :] - tbar[:, None]
            b_fit = jnp.sum(wn * tc * (woff - obar[:, None]), axis=1) / (
                jnp.sum(wn * tc * tc, axis=1) + 1e-6
            )
            a_fit = obar - b_fit * tbar
        return p0 + nrm * a_fit[:, None], p1 + nrm * (a_fit + b_fit)[:, None]

    p0, p1 = refit(p0, p1)

    ok = valid & (length >= 12.0) & (supported / jnp.maximum(length, 1.0) > 0.75)
    # Clamp endpoints to the image; re-derive angle/length from the
    # refit endpoints so downstream gates see consistent geometry.
    p0 = jnp.stack([jnp.clip(p0[:, 0], 0, w - 1), jnp.clip(p0[:, 1], 0, h - 1)], -1)
    p1 = jnp.stack([jnp.clip(p1[:, 0], 0, w - 1), jnp.clip(p1[:, 1], 0, h - 1)], -1)
    d01 = p1 - p0
    theta = jnp.mod(jnp.arctan2(d01[:, 1], d01[:, 0]), jnp.pi)
    length = jnp.linalg.norm(d01, axis=-1)
    return DetectedLines(
        p0=p0, p1=p1, angle=theta, length=length, response=supported,
        valid=ok,
    )


def merge_collinear(lines: DetectedLines, ang_tol: float = 0.06,
                    dist_tol: float = 4.0) -> DetectedLines:
    """Suppress duplicate detections of the same physical segment: for
    every pair with similar angle, nearby infinite lines and overlapping
    extent, keep the longer one.  O(L^2) masked ops, static shape."""
    L = lines.p0.shape[0]
    mid = 0.5 * (lines.p0 + lines.p1)
    d = jnp.stack([jnp.cos(lines.angle), jnp.sin(lines.angle)], -1)
    n = jnp.stack([-jnp.sin(lines.angle), jnp.cos(lines.angle)], -1)

    dang = jnp.abs(((lines.angle[:, None] - lines.angle[None, :] + jnp.pi / 2) % jnp.pi) - jnp.pi / 2)
    dm = mid[None, :, :] - mid[:, None, :]
    perp = jnp.abs(jnp.sum(dm * n[:, None, :], axis=-1))
    along = jnp.abs(jnp.sum(dm * d[:, None, :], axis=-1))
    overlap = along < 0.6 * (lines.length[:, None] + lines.length[None, :])

    dup = (dang < ang_tol) & (perp < dist_tol) & overlap
    dup = dup & lines.valid[:, None] & lines.valid[None, :]
    better = (lines.length[None, :] > lines.length[:, None]) | (
        (lines.length[None, :] == lines.length[:, None])
        & (jnp.arange(L)[None, :] < jnp.arange(L)[:, None])
    )
    suppressed = jnp.any(dup & better, axis=1)
    return lines._replace(valid=lines.valid & ~suppressed)
