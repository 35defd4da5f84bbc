"""Oriented BRIEF-256: intensity-centroid orientation + rotated pattern.

Batched replacement for ORBextractor's IC_Angle +
computeOrbDescriptor (src/ORBextractor.cc, SURVEY.md §2.1 row 9 and
§3.2 "hot loop 1").  All keypoints are processed as one batched gather:
patch reads become [N, P, P] advanced-indexing gathers, the descriptor
becomes a [N, 256] comparison of rotated-sample pairs, packed to
uint8[N, 32].

The test-pair pattern is NOT OpenCV's learned bit_pattern_31_ (we build
from scratch); it is a deterministic Gaussian BRIEF pattern
(x, y ~ N(0, (patch/5)^2), the original BRIEF G-II sampling) seeded so
every run agrees.  The engine is self-consistent: map, matching, BoW
vocabulary all use this pattern.
"""

from __future__ import annotations

import functools

import jax

import jax.numpy as jnp
import numpy as np

from .hamming import pack_bits
from .image import nearest_sample

HALF_PATCH = 15  # orientation patch radius, as ORBextractor
PATCH = 2 * HALF_PATCH + 1
BRIEF_CLIP = 13  # max |coord| of a test point, keeps rotated reads in patch


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """[256, 4] float32 rows (x1, y1, x2, y2), deterministic.

    Test points are clipped to EUCLIDEAN radius 14 so that any in-plane
    rotation keeps every sample inside the 32x32 tile (keypoint at
    (15, 15)) — axis-wise clipping would let rotated samples spill past
    the tile edge and corrupt descriptors of rotated keypoints."""
    rng = np.random.default_rng(0x0B51EF)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(256, 4)).astype(np.float32)
    for cols in ((0, 1), (2, 3)):
        r = np.sqrt(pts[:, cols[0]] ** 2 + pts[:, cols[1]] ** 2)
        scale = np.minimum(1.0, 14.0 / np.maximum(r, 1e-6))
        pts[:, cols[0]] *= scale
        pts[:, cols[1]] *= scale
    return pts


@functools.lru_cache()
def circular_mask() -> np.ndarray:
    """bool [PATCH, PATCH] disk mask of radius HALF_PATCH."""
    v, u = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    return (u * u + v * v <= HALF_PATCH * HALF_PATCH).astype(np.float32)


def gather_patches(img: jnp.ndarray, centers: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Gather square patches around integer centers.

    img: [H, W] float32; centers: int32 [N, 2] (x, y).
    Returns [N, 2r+1, 2r+1]; out-of-bounds reads clamp to the border
    (selection already avoids the border, so clamping is a no-op for
    valid keypoints).
    """
    h, w = img.shape
    d = jnp.arange(-radius, radius + 1)
    ys = jnp.clip(centers[:, 1, None, None] + d[None, :, None], 0, h - 1)
    xs = jnp.clip(centers[:, 0, None, None] + d[None, None, :], 0, w - 1)
    return img[ys, xs]


def ic_angle(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per patch [N, P, P] -> radians [N]."""
    mask = jnp.asarray(circular_mask())
    d = jnp.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=jnp.float32)
    u = d[None, None, :]  # x offsets
    v = d[None, :, None]  # y offsets
    pm = patches * mask[None]
    m10 = jnp.sum(pm * u, axis=(1, 2))
    m01 = jnp.sum(pm * v, axis=(1, 2))
    return jnp.arctan2(m01, m10)


def brief_descriptors(
    img_blur: jnp.ndarray, centers: jnp.ndarray, angles: jnp.ndarray
) -> jnp.ndarray:
    """Rotated BRIEF-256 from a blurred image.

    img_blur: [H, W] float32 (Gaussian sigma=2, as the reference).
    centers: int32 [N, 2]; angles: float32 [N] radians.
    Returns packed uint8 [N, 32].
    """
    pat = jnp.asarray(brief_pattern())  # [256, 4]
    c = jnp.cos(angles)[:, None]
    s = jnp.sin(angles)[:, None]

    def rot(px, py):
        # Steered BRIEF: rotate test points by keypoint angle.
        rx = c * px[None, :] - s * py[None, :]
        ry = s * px[None, :] + c * py[None, :]
        return rx, ry

    x1, y1 = rot(pat[:, 0], pat[:, 1])  # [N, 256]
    x2, y2 = rot(pat[:, 2], pat[:, 3])
    cx = centers[:, 0:1].astype(jnp.float32)
    cy = centers[:, 1:2].astype(jnp.float32)
    p1 = jnp.stack([cx + x1, cy + y1], axis=-1)  # [N, 256, 2]
    p2 = jnp.stack([cx + x2, cy + y2], axis=-1)
    i1 = nearest_sample(img_blur, p1)
    i2 = nearest_sample(img_blur, p2)
    bits = (i1 < i2).astype(jnp.uint8)
    return pack_bits(bits)


# ---------------------------------------------------------------------------
# Tile-based path.
#
# Each keypoint gets one 32x32 tile with the keypoint at tile index
# (15, 15) (gather_patch_tiles).  Orientation and BRIEF then read the
# tile only: BRIEF steering is quantized to 30 angle bins of 12 degrees
# (OpenCV ORB quantizes to 30 bins too), so each bin's rotated test
# points are a fixed table of flat tile indices.
# ---------------------------------------------------------------------------

N_ANGLE_BINS = 30
TILE = 32
TILE_C = 15  # keypoint index within the tile


def gather_patch_tiles(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """[N, 32, 32] float32 tiles of img; tile[15, 15] is the keypoint
    pixel, and tiles that would cross the image border are shifted
    inside it (clamped).  xy: int32 [N, 2] (x, y)."""
    with jax.named_scope("patch_gather"):
        h, w = img.shape
        x0 = jnp.clip(xy[:, 0] - TILE_C, 0, w - TILE)
        y0 = jnp.clip(xy[:, 1] - TILE_C, 0, h - TILE)
        d = jnp.arange(TILE)
        ys = y0[:, None, None] + d[None, :, None]
        xs = x0[:, None, None] + d[None, None, :]
        return img.astype(jnp.float32)[ys, xs]


@functools.lru_cache()
def _rotated_flat_indices() -> np.ndarray:
    """int32 [N_ANGLE_BINS, 512] flat tile indices of the rotated test
    points (256 pairs -> p1 points then p2 points)."""
    pat = brief_pattern()  # [256, 4]
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for half, (px, py) in enumerate(((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3]))):
            rx = np.round(c * px - s * py).astype(np.int64)
            ry = np.round(s * px + c * py).astype(np.int64)
            row = np.clip(TILE_C + ry, 0, TILE - 1)
            col = np.clip(TILE_C + rx, 0, TILE - 1)
            out[b, half * 256 : (half + 1) * 256] = row * TILE + col
    return out


# Fixed-point scale for tile intensities: 4 fractional bits.  Sampling
# and orientation both quantize the tile to round(tile * FIXED_SCALE),
# so descriptors are exact integer arithmetic, bit-identical on every
# backend.
FIXED_SCALE = 16.0


def _fixed_planes(tiles_flat: jnp.ndarray):
    """f32 [N, 1024] tiles -> (hi, lo) int8 base-64 planes of
    round(tile * FIXED_SCALE) (values in [0, 255*16], hi/lo in
    [0, 63])."""
    tf = jnp.round(tiles_flat * FIXED_SCALE).astype(jnp.int32)
    return (tf >> 6).astype(jnp.int8), (tf & 63).astype(jnp.int8)


def quantize_angle(angles: jnp.ndarray) -> jnp.ndarray:
    b = jnp.round(angles / (2.0 * jnp.pi / N_ANGLE_BINS)).astype(jnp.int32)
    return jnp.mod(b, N_ANGLE_BINS)


# Minimum intensity-centroid offset (pixels) for the angle to be
# considered signal.  Below it the IC angle is noise: steering BRIEF by
# a noisy angle decorrelates descriptors frame to frame (measured on the
# synthetic bench: median cross-frame Hamming 24 steered vs 13 upright
# for weak-centroid patches).  Snapping weak patches to upright trades
# their (already unreliable) rotation invariance for repeatability —
# strong corners keep full steering.
IC_MIN_OFFSET_PX = 0.5


@functools.lru_cache()
def _ic_weight_table() -> np.ndarray:
    """int8 [1024, 4] moment weights over the full 32x32 tile (disk
    mask x {u, v, 1}, zero outside the 31x31 patch; the 4th column is
    zero padding).  Entries are in [-15, 15] so the moments
    are EXACT int32 under the fixed-point planes."""
    mask = circular_mask()  # [31, 31]
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    W = np.zeros((TILE, TILE, 4), np.int8)
    W[:31, :31, 0] = mask * d[None, :]  # m10 weight (x)
    W[:31, :31, 1] = mask * d[:, None]  # m01 weight (y)
    W[:31, :31, 2] = mask               # m00 weight
    return W.reshape(TILE * TILE, 4)


def ic_angle_from_tiles(tiles: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle from [N, 32, 32] tiles (center (15,15)).

    Fixed-point int8 matmul: moments come out EXACT (scaled by
    FIXED_SCALE, which cancels in both arctan2 and the offset/m00
    ratio), so every backend agrees bit-for-bit — an f32 matvec under a
    reduced default matmul precision diverges from the CPU at ~1e-3,
    enough to flip angle bins.
    Weak centroids snap to upright (see IC_MIN_OFFSET_PX)."""
    n = tiles.shape[0]
    hi, lo = _fixed_planes(tiles.reshape(n, -1))
    W = jnp.asarray(_ic_weight_table())
    dims = (((1,), (0,)), ((), ()))
    mh = jax.lax.dot_general(hi, W, dims, preferred_element_type=jnp.int32)
    ml = jax.lax.dot_general(lo, W, dims, preferred_element_type=jnp.int32)
    m = (mh * 64 + ml).astype(jnp.float32)
    m10, m01, m00 = m[:, 0], m[:, 1], m[:, 2]
    offset = jnp.sqrt(m10 * m10 + m01 * m01) / jnp.maximum(m00, 1e-6)
    return jnp.where(
        offset >= IC_MIN_OFFSET_PX, jnp.arctan2(m01, m10), 0.0
    )


def brief_descriptors_from_tiles(
    tiles_blur: jnp.ndarray, angles: jnp.ndarray
) -> jnp.ndarray:
    """Rotated BRIEF-256 from blurred-image tiles [N, 32, 32]: one
    gather of the 512 quantized test points of each keypoint's angle
    bin, compared in fixed point (exact, so every backend gives the
    same bits)."""
    n = tiles_blur.shape[0]
    bins = quantize_angle(angles)
    tf = jnp.round(tiles_blur.reshape(n, -1) * FIXED_SCALE).astype(jnp.int32)
    idx = jnp.asarray(_rotated_flat_indices())[bins]  # [N, 512]
    vals = jnp.take_along_axis(tf, idx, axis=1)
    diff = vals[:, 256:] - vals[:, :256]
    return pack_bits((diff > 0).astype(jnp.uint8))
