"""Image ops: pyramid, separable Gaussian blur, gradients, bilinear sampling.

Replaces the reference's OpenCV image plumbing used by ORBextractor
(ComputePyramid, GaussianBlur — src/ORBextractor.cc, SURVEY.md §2.1
row 9) with static-shape jax.numpy that XLA fuses well.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _gaussian_taps(sigma: float, radius: int) -> tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple((k / k.sum()).astype(np.float32).tolist())


@functools.lru_cache(maxsize=256)
def _banded(n: int, taps: tuple) -> np.ndarray:
    """[n, n] banded filter matrix; out-of-range taps drop (zero-pad
    borders, matching lax.conv with zero padding)."""
    r = (len(taps) - 1) // 2
    M = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for i, kv in enumerate(taps):
        src = idx - (i - r)
        m = (src >= 0) & (src < n)
        M[idx[m], src[m]] += kv
    return M


def separable_filter(img: jnp.ndarray, taps_y: tuple, taps_x: tuple) -> jnp.ndarray:
    """Separable FIR filter of [..., H, W] as two banded matmuls,
    [H,H] @ img @ [W,W]^T (whether a convolution is faster on the GPU
    is not measured yet: ROADMAP D9).  Always HIGHEST (full f32): it
    keeps the error ~1e-4 at pixel magnitude (the BRIEF-bit
    requirement), and even the line detector, whose outputs only feed
    coarse thresholds, loses 6% of its lines to TF32 (GPU parity run);
    a one-pass bf16 product flips border pixels by ~1."""
    h, w = img.shape[-2], img.shape[-1]
    My = jnp.asarray(_banded(h, taps_y))
    Mx = jnp.asarray(_banded(w, taps_x))
    hp = jax.lax.Precision.HIGHEST
    x = jnp.matmul(My, img, precision=hp)
    return jnp.matmul(x, Mx.T, precision=hp)


def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur of a [..., H, W] float image (ORBextractor
    uses 7x7 sigma=2 before describing — same defaults here)."""
    taps = _gaussian_taps(sigma, radius)
    return separable_filter(img, taps, taps)


@functools.lru_cache(maxsize=256)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] row-interpolation matrix reproducing
    jax.image.resize(method='bilinear') semantics: half-pixel centers
    with an anti-aliasing triangle kernel when downsampling."""
    scale = n_out / n_in
    # Kernel support in input pixels (>=1: plain bilinear when upsizing).
    inv = max(1.0 / scale, 1.0)
    x = (np.arange(n_out) + 0.5) / scale - 0.5        # input coords
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) / inv)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize_bilinear(img: jnp.ndarray, new_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear (anti-aliased) resize of a 2D image (pyramid levels) as
    two interpolation matmuls in f32 HIGHEST.

    jax.image.resize can lower through default-precision (bf16 or TF32)
    matmuls on an accelerator, which perturbs pyramid pixels by up to
    ~0.5 — enough to flip borderline BRIEF bits and break device/CPU
    descriptor parity (guarded by tests/test_gpu_parity.py)."""
    h2, w2 = new_hw
    h1, w1 = img.shape
    My = jnp.asarray(_resize_matrix(h2, h1))
    Mx = jnp.asarray(_resize_matrix(w2, w1))
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(My, img, precision=hp), Mx.T, precision=hp)


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    return [
        (max(8, int(round(h / scale**i))), max(8, int(round(w / scale**i))))
        for i in range(n_levels)
    ]


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float) -> list[jnp.ndarray]:
    """Image pyramid as a list of float32 2D arrays (one static shape per
    level, like ORBextractor::ComputePyramid's mvImagePyramid)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img.astype(jnp.float32)]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lvl]))
    return levels


def sobel_gradients(img: jnp.ndarray):
    """Sobel dx, dy of a [..., H, W] float image (line detection / LBD
    front-end), as banded matmuls — see separable_filter."""
    smooth = (1.0, 2.0, 1.0)
    # Tap order matches the previous lax.conv kernels (verified
    # numerically): (1, 0, -1) reproduces the old [-1, 0, 1] Sobel rows.
    diff = (1.0, 0.0, -1.0)
    gx = separable_filter(img, smooth, diff)
    gy = separable_filter(img, diff, smooth)
    return gx, gy


def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Sample an image at float coords xy (..., 2) = (x, y), bilinear,
    clamped to borders. Gather-based: vectorizes over any batch shape.

    img may be [H, W] (returns xy.shape[:-1]) or [H, W, C] (returns
    xy.shape[:-1] + (C,)): multi-channel sampling gathers C-float rows
    with ONE take, so co-located fields (edge mask + angle fields,
    gx + gy) cost one gather instead of one per field.

    Indexes the flattened image with a single fused index (y*w + x),
    one 1-D `take` instead of 2-D advanced indexing."""
    channels = img.ndim == 3
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, -1) if channels else img.reshape(-1)
    x = jnp.clip(xy[..., 0], 0.0, w - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    r0 = y0 * w
    r1 = y1 * w
    v00 = jnp.take(flat, r0 + x0, axis=0)
    v01 = jnp.take(flat, r0 + x1, axis=0)
    v10 = jnp.take(flat, r1 + x0, axis=0)
    v11 = jnp.take(flat, r1 + x1, axis=0)
    if channels:
        fx = fx[..., None]
        fy = fy[..., None]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def nearest_sample(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbour sample (used by BRIEF's rotated pattern, which
    OpenCV rounds with cvRound).  Flat-index gather, as
    bilinear_sample."""
    h, w = img.shape
    x = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, h - 1)
    return jnp.take(img.reshape(-1), y * w + x)


def pyramid_atlas(levels: list[jnp.ndarray]):
    """Stack pyramid levels into one vertically-concatenated atlas.

    Enables per-keypoint octave-dependent patch gathers from a single
    static-shape array: level L lives at rows
    [offset[L], offset[L]+h_L).  Returns (atlas [sumH, maxW] float32,
    offsets int32 [n_levels]).
    """
    max_w = max(l.shape[1] for l in levels)
    offs = []
    padded = []
    y = 0
    for l in levels:
        offs.append(y)
        y += l.shape[0]
        padded.append(jnp.pad(l, ((0, 0), (0, max_w - l.shape[1]))))
    return jnp.concatenate(padded, axis=0), jnp.asarray(offs, dtype=jnp.int32)
