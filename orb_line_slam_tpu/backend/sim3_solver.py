"""Sim3 estimation: Horn closed-form alignment inside batched RANSAC.

Rebuilds src/Sim3Solver.cc (SURVEY.md §2.1 row 15): 3-point Horn
similarity between matched 3D point sets, scale free (mono) or fixed
to 1 (stereo), with reprojection-error inlier counting.  The
reference's adaptive RANSAC loop becomes one batched evaluation of a
fixed hypothesis budget — every hypothesis solved and scored in
parallel on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
_HI = jax.lax.Precision.HIGHEST  # small-K geometry: bf16-unsafe

from ..geometry.camera import CameraIntrinsics, project


def horn_alignment(p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool):
    """Closed-form similarity aligning p2 -> p1 (both [..., N, 3]).

    Returns (s, R, t) with p1 ~ s * R @ p2 + t.  Horn's method with the
    rotation from SVD of the correlation (batched-safe).
    """
    c1 = jnp.mean(p1, axis=-2, keepdims=True)
    c2 = jnp.mean(p2, axis=-2, keepdims=True)
    x1 = p1 - c1
    x2 = p2 - c2
    M = jnp.einsum("...ni,...nj->...ij", x1, x2, precision=_HI)  # correlation
    U, D, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(jnp.matmul(U, Vt, precision=_HI))
    S = jnp.broadcast_to(jnp.eye(3), M.shape).copy()
    S = S.at[..., 2, 2].set(det)
    R = jnp.matmul(jnp.matmul(U, S, precision=_HI), Vt, precision=_HI)
    if fix_scale:
        s = jnp.ones(M.shape[:-2])
    else:
        num = jnp.sum(x1 * jnp.einsum("...ij,...nj->...ni", R, x2, precision=_HI), axis=(-2, -1))
        den = jnp.sum(x2 * x2, axis=(-2, -1)) + 1e-12
        s = num / den
    t = c1[..., 0, :] - s[..., None] * jnp.einsum("...ij,...j->...i", R, c2[..., 0, :], precision=_HI)
    return s, R, t


@functools.partial(
    jax.jit, static_argnames=("cam1", "cam2", "fix_scale", "n_hyps")
)
def solve_sim3_ransac(
    pts1: jnp.ndarray,     # [N, 3] points in frame-1 camera coords
    pts2: jnp.ndarray,     # [N, 3] matched points in frame-2 camera coords
    valid: jnp.ndarray,    # [N]
    key: jnp.ndarray,      # PRNG key
    cam1: CameraIntrinsics,
    cam2: CameraIntrinsics,
    sigma2_1: jnp.ndarray,  # [N] per-match max reproj chi2 in image 1
    sigma2_2: jnp.ndarray,  # [N]
    fix_scale: bool = True,
    n_hyps: int = 256,
):
    """Batched RANSAC Sim3: returns (s, R, t) of T_12 (maps 2->1 coords),
    per-match inlier mask, and inlier count."""
    N = pts1.shape[0]
    # Sample 3-point hypotheses from valid matches (weighted by mask).
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyps, 3), replace=True, p=p)
    h1 = pts1[idx]  # [H, 3, 3]
    h2 = pts2[idx]
    s, R, t = horn_alignment(h1, h2, fix_scale)  # batched over H

    # Score: symmetric reprojection error.
    def reproj_inliers(s, R, t):
        # transform pts2 into frame 1
        p2in1 = s[..., None, None] * jnp.einsum("hij,nj->hni", R, pts2, precision=_HI) + t[:, None, :]
        uv1 = project(cam1, p2in1)
        e1 = jnp.sum((uv1 - project(cam1, pts1)[None]) ** 2, axis=-1)
        # inverse transform pts1 into frame 2
        s_i = 1.0 / s
        R_i = jnp.swapaxes(R, -1, -2)
        t_i = -s_i[:, None] * jnp.einsum("hij,hj->hi", R_i, t, precision=_HI)
        p1in2 = s_i[..., None, None] * jnp.einsum("hij,nj->hni", R_i, pts1, precision=_HI) + t_i[:, None, :]
        uv2 = project(cam2, p1in2)
        e2 = jnp.sum((uv2 - project(cam2, pts2)[None]) ** 2, axis=-1)
        ok = (e1 < 9.21 * sigma2_1[None]) & (e2 < 9.21 * sigma2_2[None])
        return ok & valid[None]

    inl = reproj_inliers(s, R, t)  # [H, N]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return (
        s[best], R[best], t[best], inl[best], counts[best],
    )
