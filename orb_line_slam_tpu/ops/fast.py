"""FAST-9/16 corner detection as dense, data-parallel stencils.

Static-shape JAX replacement for the per-cell cv::FAST calls inside
ORBextractor::ComputeKeyPointsOctTree (src/ORBextractor.cc, SURVEY.md
§2.1 row 9 and §3.2 "hot loop 1").  Instead of the reference's
sequential per-cell detection + octree redistribution, we compute a
dense corner-score map over the whole level with 16 rolled copies of
the image (pure VPU work, fused by XLA) and distribute spatially with
per-cell top-K selection (ops/topk_grid.py).

The score equals the classical FAST score: the maximum threshold t at
which a contiguous arc of >= 9 circle pixels is all brighter (darker)
than center +/- t.  With arc-min formulation:
    score_bright = max_s min_{i<9} (I[p + c_{s+i}] - I[p])
and symmetrically for dark; corner iff score > threshold.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3, OpenCV pixel order (dx, dy).
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC_LEN = 9
BORDER = 3


def fast_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9 corner score for a 2D float32 image.

    Returns float32 [H, W]; score <= 0 means not a corner at any
    threshold. Border (3 px) is forced to 0.
    """
    h, w = img.shape
    diffs = []
    for dx, dy in CIRCLE_OFFSETS:
        shifted = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))
        diffs.append(shifted - img)

    def arc_score(ds):
        best = None
        for s in range(16):
            arc_min = ds[s % 16]
            for i in range(1, ARC_LEN):
                arc_min = jnp.minimum(arc_min, ds[(s + i) % 16])
            best = arc_min if best is None else jnp.maximum(best, arc_min)
        return best

    bright = arc_score(diffs)
    dark = arc_score([-d for d in diffs])
    score = jnp.maximum(bright, dark)

    # Zero the border where rolls wrap around.
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (
        (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    )
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep score only at local maxima.

    Ties are broken toward the lexically-first pixel so that plateaus
    yield exactly one survivor.
    """
    keep = jnp.ones_like(score, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = jnp.roll(score, shift=(-dy, -dx), axis=(0, 1))
            if (dy, dx) < (0, 0):
                # Earlier in raster order: require strict win so a flat
                # plateau keeps only its first pixel.
                keep &= score > neigh
            else:
                keep &= score >= neigh
    return jnp.where(keep, score, 0.0)
