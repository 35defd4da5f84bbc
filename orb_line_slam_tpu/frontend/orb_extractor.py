"""Batched multi-level ORB extraction — the front-end "hot loop 1".

Static-shape JAX rebuild of ORBextractor::operator() (src/ORBextractor.cc,
SURVEY.md §2.1 row 9, §3.2): 8-level pyramid (scale 1.2), dense FAST-9
score stencil + 3x3 NMS per level, per-cell top-K spatial distribution
(replacing the sequential octree), intensity-centroid orientation,
Gaussian blur, rotated BRIEF-256 — all static-shape, batched over
keypoints, one jit per image geometry.

The reference runs left/right extraction on two pthreads
(Frame stereo ctor, SURVEY.md §2.4); here both images go through the
same jitted program back to back (or batched by the caller) and the
parallelism comes from the device, not threads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import OrbConfig
from ..ops.brief import (
    brief_descriptors_from_tiles,
    gather_patch_tiles,
    ic_angle_from_tiles,
)
from ..ops.fast import fast_score_map, nms3x3
from ..ops.image import build_pyramid, gaussian_blur, pyramid_shapes
from ..ops.topk_grid import select_topk_grid


class FrameFeatures(NamedTuple):
    """SoA keypoints+descriptors, padded to the static feature budget."""

    xy: jnp.ndarray      # float32 [N, 2] — level-0 pixel coords
    response: jnp.ndarray  # float32 [N]
    angle: jnp.ndarray   # float32 [N] radians
    octave: jnp.ndarray  # int32 [N]
    desc: jnp.ndarray    # uint8 [N, 32] packed BRIEF-256
    valid: jnp.ndarray   # bool [N]

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _detect_level(img, quota, cfg: OrbConfig):
    """FAST + NMS + grid top-K on one level (no description yet).

    Returns (xy int32, delta float32 [-0.5,0.5], resp, valid): delta is
    the sub-pixel offset from a 1D parabola fit over the raw FAST score
    in each axis.  The reference keeps integer keypoints per level
    (src/ORBextractor.cc); the sub-pixel refinement measurably
    stabilizes octave selection, orientation and BRIEF under sub-pixel
    image motion (see frontend docstring) — detections jitter by ±0.5
    level-pixels otherwise, which at level 5 is ±3.7 px at level 0."""
    raw = fast_score_map(img)
    score = nms3x3(raw)
    h, w = img.shape
    m = cfg.edge_margin
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = jnp.where(interior, score, 0.0)

    n_cells = max(1, (h // cfg.cell_size) * (w // cfg.cell_size))
    k_per_cell = max(1, min(16, (3 * quota) // n_cells + 1))
    xy, resp, valid = select_topk_grid(
        score, cfg.cell_size, k_per_cell, quota, cfg.min_th_fast
    )
    # Sub-pixel: parabola over the raw (pre-NMS) score in each axis.
    x, y = xy[:, 0], xy[:, 1]

    def at(dy, dx):
        return raw[jnp.clip(y + dy, 0, h - 1), jnp.clip(x + dx, 0, w - 1)]

    sc = at(0, 0)
    dl, dr = at(0, -1), at(0, 1)
    du, dd = at(-1, 0), at(1, 0)
    denx = 2.0 * sc - dl - dr
    deny = 2.0 * sc - du - dd
    dx = jnp.where(denx > 1e-6, 0.5 * (dr - dl) / denx, 0.0)
    dy = jnp.where(deny > 1e-6, 0.5 * (dd - du) / deny, 0.0)
    delta = jnp.stack([dx, dy], axis=-1)
    delta = jnp.clip(delta, -0.5, 0.5)
    return xy, delta, resp, valid


def shift_tiles(tiles: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Resample [N, 32, 32] tiles so the keypoint's sub-pixel position
    lands exactly on tile index (15, 15): bilinear shift by -delta,
    expressed as 9 static slices of an edge-padded tile (pure VPU)."""
    tp = jnp.pad(tiles, ((0, 0), (1, 1), (1, 1)), mode="edge")
    dx = delta[:, 0][:, None, None]
    dy = delta[:, 1][:, None, None]
    wx = {
        -1: jnp.maximum(-dx, 0.0),
        0: 1.0 - jnp.abs(dx),
        1: jnp.maximum(dx, 0.0),
    }
    wy = {
        -1: jnp.maximum(-dy, 0.0),
        0: 1.0 - jnp.abs(dy),
        1: jnp.maximum(dy, 0.0),
    }
    out = jnp.zeros_like(tiles)
    for oy, wyo in wy.items():
        for ox, wxo in wx.items():
            out = out + wyo * wxo * tp[:, 1 + oy : 33 + oy, 1 + ox : 33 + ox]
    return out


def blur_tiles(tiles: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur applied to the patch tiles themselves
    (instead of the whole level): BRIEF samples live within +-13 px of
    the center, so only the outermost ring differs from a full-image
    blur — and identically so on every frame, which is what matching
    needs."""
    from ..ops.image import gaussian_kernel1d

    k = gaussian_kernel1d(sigma, radius)
    kh = k.reshape(1, 1, 1, -1)
    kv = k.reshape(1, 1, -1, 1)

    def conv(x):
        dn = jax.lax.conv_dimension_numbers(
            x.shape, kh.shape, ("NCHW", "OIHW", "NCHW")
        )
        # HIGHEST: a one-pass bf16 conv adds ~0.25 noise at pixel
        # magnitude; BRIEF bits compare pairs of these blurred values,
        # so that noise flips borderline bits (measured: ~4 bits of
        # device-vs-CPU descriptor disagreement, enough to halve
        # tracking inliers through the TH_LOW/ratio gates).
        x = jax.lax.conv_general_dilated(
            x, kh, (1, 1), [(0, 0), (radius, radius)], dimension_numbers=dn,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jax.lax.conv_general_dilated(
            x, kv, (1, 1), [(radius, radius), (0, 0)], dimension_numbers=dn,
            precision=jax.lax.Precision.HIGHEST,
        )

    out = conv(tiles[:, None, :, :])[:, 0]
    # Normalized convolution: divide by the blurred all-ones tile so the
    # zero padding doesn't darken the border ring (BRIEF samples reach
    # radius 14 of the 32x32 tile; a darkened rim flips bits whenever
    # the rotation moves samples across it).
    norm = conv(jnp.ones((1, 1) + tiles.shape[1:], tiles.dtype))[0, 0]
    return out / norm[None]


@functools.lru_cache()
def _shift_blur_mats(sigma: float = 2.0, radius: int = 3):
    """Three static f32 [32, 32] matrices (B@S-, B, B@S+) composing the
    per-axis sub-pixel shift with the normalized Gaussian blur.

    B is the zero-padded blur band row-normalized (identical to
    conv+divide-by-conv(ones): the 2D normalizer separates into row
    sums).  S-/S+ are 1-pixel shifts with edge clamp (shift_tiles pads
    with mode="edge").  The bilinear shift is S(d) = w-*S- + w0*I +
    w+*S+ per axis, so shift-then-blur per axis is the same weighted
    combination of these three static matrices — which turns the whole
    shift+blur+normalize stage into 6 static [32,32]x[32,N*32]
    matmuls instead of padded-slice passes + a batched conv."""
    import numpy as np

    from ..ops.image import _gaussian_taps

    k = np.asarray(_gaussian_taps(sigma, radius), np.float32)
    n = 32
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(2 * radius + 1):
            j = i + t - radius
            if 0 <= j < n:
                B[i, j] = k[t]
    B /= B.sum(axis=1, keepdims=True)
    Sm = np.zeros((n, n), np.float32)
    Sp = np.zeros((n, n), np.float32)
    for i in range(n):
        Sm[i, max(i - 1, 0)] = 1.0
        Sp[i, min(i + 1, n - 1)] = 1.0
    return B @ Sm, B, B @ Sp


def shift_blur_tiles(tiles: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Fused sub-pixel shift + normalized Gaussian blur of [N, 32, 32]
    tiles (see _shift_blur_mats).  Equivalent to
    blur_tiles(shift_tiles(tiles, delta)) up to f32 summation order."""
    Am, A0, Ap = (jnp.asarray(m) for m in _shift_blur_mats())
    hp = jax.lax.Precision.HIGHEST

    def axis_weights(d):
        return jnp.maximum(-d, 0.0), 1.0 - jnp.abs(d), jnp.maximum(d, 0.0)

    wmy, w0y, wpy = axis_weights(delta[:, 1][:, None, None])
    wmx, w0x, wpx = axis_weights(delta[:, 0][:, None, None])
    ty = (
        wmy * jnp.einsum("ij,njk->nik", Am, tiles, precision=hp)
        + w0y * jnp.einsum("ij,njk->nik", A0, tiles, precision=hp)
        + wpy * jnp.einsum("ij,njk->nik", Ap, tiles, precision=hp)
    )
    return (
        wmx * jnp.einsum("nik,lk->nil", ty, Am, precision=hp)
        + w0x * jnp.einsum("nik,lk->nil", ty, A0, precision=hp)
        + wpx * jnp.einsum("nik,lk->nil", ty, Ap, precision=hp)
    )


def extract_orb_with_tiles(image: jnp.ndarray, cfg: OrbConfig):
    """Full multi-level ORB extraction; also returns the raw patch
    tiles ([N, 32, 32], keypoint at (15,15) in the keypoint's own
    pyramid level) so the stereo matcher can reuse them for SAD.

    Detection runs per pyramid level; description is batched over ALL
    levels through a vertically-stacked pyramid atlas, so the patch
    gather and the BRIEF sampling run once per image regardless of
    n_levels.
    """
    from ..ops.image import pyramid_atlas

    img = image.astype(jnp.float32)
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    atlas_raw, offs = pyramid_atlas(levels)
    quotas = cfg.level_quotas
    scales = cfg.level_scales

    all_xy, all_axy, all_d, all_resp, all_oct, all_valid = [], [], [], [], [], []
    for lvl in range(cfg.n_levels):
        xy, delta, resp, valid = _detect_level(levels[lvl], quotas[lvl], cfg)
        all_xy.append((xy.astype(jnp.float32) + delta) * scales[lvl])
        all_axy.append(xy + jnp.array([[0, 1]], jnp.int32) * offs[lvl])
        all_d.append(delta)
        all_resp.append(resp)
        all_oct.append(jnp.full((quotas[lvl],), lvl, dtype=jnp.int32))
        all_valid.append(valid)

    axy = jnp.concatenate(all_axy, axis=0)  # atlas coords, int32
    tiles_raw = gather_patch_tiles(atlas_raw, axy)
    deltas = jnp.concatenate(all_d, axis=0)
    tiles = shift_tiles(tiles_raw, deltas)
    tiles_blur = shift_blur_tiles(tiles_raw, deltas)
    # Orientation from the blurred tile: the raw intensity centroid is
    # noise-dominated for weak-gradient patches; blur stabilizes the
    # angle (and therefore the BRIEF rotation bin) across frames.
    angles = ic_angle_from_tiles(tiles_blur)
    desc = brief_descriptors_from_tiles(tiles_blur, angles)

    feat = FrameFeatures(
        xy=jnp.concatenate(all_xy, axis=0),
        response=jnp.concatenate(all_resp, axis=0),
        angle=angles,
        octave=jnp.concatenate(all_oct, axis=0),
        desc=desc,
        valid=jnp.concatenate(all_valid, axis=0),
    )
    return feat, tiles


@functools.partial(jax.jit, static_argnames=("cfg",))
def extract_orb(image: jnp.ndarray, cfg: OrbConfig) -> FrameFeatures:
    """Full multi-level ORB extraction of a grayscale image.

    Args:
      image: uint8 or float32 [H, W].
      cfg: OrbConfig (static — one compilation per image geometry).

    Returns:
      FrameFeatures with N = cfg.n_features rows (padded, masked).
    """
    feat, _ = extract_orb_with_tiles(image, cfg)
    return feat


def extract_orb_stereo(img_left: jnp.ndarray, img_right: jnp.ndarray, cfg: OrbConfig):
    """Joint extraction for a stereo pair: detection per image/level, but
    ONE stacked atlas + one patch gather per image + ONE BRIEF pass
    for both images (the reference parallelizes L/R with two pthreads;
    here both feed the same device kernels).

    Returns (featL, tilesL, featR, tilesR).
    """
    from ..ops.image import pyramid_atlas

    per_image = []
    atlases = []
    offs = None
    for image in (img_left, img_right):
        img = image.astype(jnp.float32)
        levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        atlas, offs = pyramid_atlas(levels)
        all_xy, all_axy, all_d, all_resp, all_oct, all_valid = [], [], [], [], [], []
        for lvl in range(cfg.n_levels):
            xy, delta, resp, valid = _detect_level(levels[lvl], cfg.level_quotas[lvl], cfg)
            all_xy.append((xy.astype(jnp.float32) + delta) * cfg.level_scales[lvl])
            all_axy.append(xy + jnp.array([[0, 1]], jnp.int32) * offs[lvl])
            all_d.append(delta)
            all_resp.append(resp)
            all_oct.append(jnp.full((cfg.level_quotas[lvl],), lvl, dtype=jnp.int32))
            all_valid.append(valid)
        per_image.append(
            (
                jnp.concatenate(all_xy),
                jnp.concatenate(all_axy),
                jnp.concatenate(all_resp),
                jnp.concatenate(all_oct),
                jnp.concatenate(all_valid),
                jnp.concatenate(all_d),
            )
        )
        atlases.append(atlas)

    # One tile gather per image atlas, then ONE orientation/blur/BRIEF
    # pass over the concatenated tiles.
    tiles_raw = jnp.concatenate(
        [
            gather_patch_tiles(atlases[0], per_image[0][1]),
            gather_patch_tiles(atlases[1], per_image[1][1]),
        ]
    )
    # Descriptors/orientation: sub-pixel-aligned tiles (stability).
    # Stereo SAD keeps the RAW integer-aligned tiles: bilinear shifting
    # blurs each side by a different sub-pixel phase, and that asymmetry
    # biases the SAD parabola ~0.04 px one-sided (≈+0.1% depth), which
    # the keyframe feedback loop integrates into forward drift.
    tiles_blur = shift_blur_tiles(
        tiles_raw, jnp.concatenate([per_image[0][5], per_image[1][5]])
    )
    angles = ic_angle_from_tiles(tiles_blur)
    desc = brief_descriptors_from_tiles(tiles_blur, angles)

    n = cfg.n_features
    feats = []
    for i, (xy, _, resp, octv, valid, _d) in enumerate(per_image):
        feats.append(
            FrameFeatures(
                xy=xy,
                response=resp,
                angle=angles[i * n : (i + 1) * n],
                octave=octv,
                desc=desc[i * n : (i + 1) * n],
                valid=valid,
            )
        )
    # per_image[i][5] is the sub-pixel detect offset: the raw tiles are
    # anchored at xy_int = xy/scale - delta, which the stereo SAD needs
    # to anchor disparity consistently with the sub-pixel keypoint.
    return (
        feats[0], tiles_raw[:n], per_image[0][5],
        feats[1], tiles_raw[n:], atlases[1], offs,
    )
