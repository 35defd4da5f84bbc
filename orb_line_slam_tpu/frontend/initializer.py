"""Monocular map initialization: parallel H/F RANSAC + motion recovery.

Rebuilds src/Initializer.cc (SURVEY.md §2.1 row 16): homography (4-pt
DLT) and fundamental (8-pt) hypotheses scored in parallel with
symmetric transfer errors, model selection by the reference's
RH = SH/(SH+SF) > 0.40 rule, motion recovery (Faugeras decomposition
for H, essential decomposition for F), cheirality + parallax checks via
batched triangulation.  RANSAC loops become fixed hypothesis batches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Small-K geometry contractions: reduced default matmul precision (bf16,
# or TF32 on the GPU) corrupts DLT/reprojection at pixel scale
# (tools/exp_numerics.py); HIGHEST is free at these shapes.
_HI = jax.lax.Precision.HIGHEST

from ..geometry.camera import CameraIntrinsics


class InitResult(NamedTuple):
    success: jnp.ndarray    # bool scalar
    R: jnp.ndarray          # [3,3] cam2<-cam1 (world = cam1)
    t: jnp.ndarray          # [3] unit-norm translation
    points3d: jnp.ndarray   # [N, 3] triangulated (in cam1 frame)
    inliers: jnp.ndarray    # [N] bool
    used_homography: jnp.ndarray  # bool scalar


def _normalize(pts):
    c = jnp.mean(pts, axis=0)
    d = jnp.mean(jnp.linalg.norm(pts - c, axis=1)) + 1e-9
    s = jnp.sqrt(2.0) / d
    T = jnp.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
    return (pts - c) * s, T


def _dlt_homography(p1, p2):
    """4+ point DLT: H with p2 ~ H p1. p1/p2 [k, 2] normalized."""
    k = p1.shape[0]
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    z = jnp.zeros(k)
    o = jnp.ones(k)
    rows1 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=1)
    rows2 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=1)
    A = jnp.concatenate([rows1, rows2], axis=0)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    return vecs[:, 0].reshape(3, 3)


def _eight_point(p1, p2):
    """8+ point fundamental: p2^T F p1 = 0. Inputs normalized [k,2]."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x)
    A = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], axis=1)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    F = vecs[:, 0].reshape(3, 3)
    # enforce rank 2
    U, D, Vt = jnp.linalg.svd(F)
    D = D.at[2].set(0.0)
    return U @ jnp.diag(D) @ Vt


def _homography_score(H, p1, p2, sigma2):
    """Symmetric transfer error score (Initializer::CheckHomography)."""
    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones((a.shape[0], 1))], axis=1)
        bh = jnp.matmul(ah, H.T, precision=_HI)
        w = jnp.where(jnp.abs(bh[:, 2:3]) < 1e-9, 1e-9, bh[:, 2:3])
        return jnp.sum((bh[:, :2] / w - b) ** 2, axis=1)

    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3))
    e12 = transfer(H, p1, p2) / sigma2
    e21 = transfer(Hinv, p2, p1) / sigma2
    th = 5.991
    score = jnp.where(e12 < th, th - e12, 0.0) + jnp.where(e21 < th, th - e21, 0.0)
    inl = (e12 < th) & (e21 < th)
    return score, inl


def _fundamental_score(F, p1, p2, sigma2):
    """Symmetric epipolar distance score (Initializer::CheckFundamental)."""
    ah = jnp.concatenate([p1, jnp.ones((p1.shape[0], 1))], axis=1)
    bh = jnp.concatenate([p2, jnp.ones((p2.shape[0], 1))], axis=1)
    l2 = jnp.matmul(ah, F.T, precision=_HI)  # line in image 2
    l1 = jnp.matmul(bh, F, precision=_HI)
    d2 = (jnp.sum(bh * l2, axis=1) ** 2) / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = (jnp.sum(ah * l1, axis=1) ** 2) / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    th, th_score = 3.841, 5.991
    s2 = d2 / sigma2
    s1 = d1 / sigma2
    score = jnp.where(s2 < th, th_score - s2, 0.0) + jnp.where(
        s1 < th, th_score - s1, 0.0
    )
    inl = (s1 < th) & (s2 < th)
    return score, inl


def triangulate_two_view(R, t, K, p1, p2):
    """Linear triangulation of pixel matches under (I|0) and (R|t).
    Returns [N, 3] points in camera-1 frame."""
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)

    def rows(a, b):
        return jnp.stack(
            [
                a[0] * P1[2] - P1[0],
                a[1] * P1[2] - P1[1],
                b[0] * P2[2] - P2[0],
                b[1] * P2[2] - P2[1],
            ]
        )

    # Inhomogeneous DLT (fix X4=1): solve A[:, :3] X = -A[:, 3] by
    # normal equations with the closed-form 3x3 inverse.  The batched
    # eigh of the homogeneous form cost ~8 ms at N=2000 on chip; this is
    # <0.5 ms and differs only for points at infinity, which the
    # downstream depth/parallax checks reject anyway.
    from ..backend.assembly import inv33

    A = jax.vmap(rows)(p1, p2)            # [N, 4, 4]
    A3 = A[:, :, :3]
    b3 = -A[:, :, 3]
    M = jnp.einsum("nri,nrj->nij", A3, A3, precision=_HI)
    rhs = jnp.einsum("nri,nr->ni", A3, b3, precision=_HI)
    M = M + 1e-9 * jnp.eye(3)
    return jnp.einsum("nij,nj->ni", inv33(M), rhs, precision=_HI)


def _check_rt(R, t, K, p1, p2, inl, sigma2):
    """Cheirality + reprojection check of a motion hypothesis; returns
    (n_good, points3d, good_mask, median_parallax_cos)."""
    pts = triangulate_two_view(R, t, K, p1, p2)
    z1 = pts[:, 2]
    pc2 = jnp.matmul(pts, R.T, precision=_HI) + t
    z2 = pc2[:, 2]
    # reprojection errors
    pr1 = jnp.matmul(pts, K.T, precision=_HI)
    pr1 = pr1[:, :2] / jnp.where(jnp.abs(pr1[:, 2:]) < 1e-9, 1e-9, pr1[:, 2:])
    pr2 = jnp.matmul(pc2, K.T, precision=_HI)
    pr2 = pr2[:, :2] / jnp.where(jnp.abs(pr2[:, 2:]) < 1e-9, 1e-9, pr2[:, 2:])
    e1 = jnp.sum((pr1 - p1) ** 2, axis=1)
    e2 = jnp.sum((pr2 - p2) ** 2, axis=1)
    # parallax
    c2 = -R.T @ t
    r1 = pts
    r2 = pts - c2
    cosp = jnp.sum(r1 * r2, axis=1) / (
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1) + 1e-12
    )
    good = (
        inl & (z1 > 0) & (z2 > 0)
        & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
        & (cosp < 0.99998)
    )
    med_cos = jnp.nanmedian(jnp.where(good, cosp, jnp.nan))
    med_cos = jnp.where(jnp.isnan(med_cos), 1.0, med_cos)
    return jnp.sum(good), pts, good, med_cos


@functools.partial(jax.jit, static_argnames=("cam", "n_hyps"))
def initialize_two_view(
    p1_px: jnp.ndarray,   # [N, 2] matched keypoints, frame 1
    p2_px: jnp.ndarray,   # [N, 2] frame 2
    valid: jnp.ndarray,   # [N]
    key: jnp.ndarray,
    cam: CameraIntrinsics,
    sigma: float = 1.0,
    n_hyps: int = 200,
) -> InitResult:
    N = p1_px.shape[0]
    K = cam.K
    sigma2 = sigma * sigma

    prob = valid.astype(jnp.float32)
    prob = prob / jnp.maximum(prob.sum(), 1.0)
    idxH = jax.random.choice(key, N, shape=(n_hyps, 4), replace=True, p=prob)
    idxF = jax.random.choice(
        jax.random.fold_in(key, 1), N, shape=(n_hyps, 8), replace=True, p=prob
    )

    p1n, T1 = _normalize(p1_px)
    p2n, T2 = _normalize(p2_px)

    def hypH(i):
        H = _dlt_homography(p1n[idxH[i]], p2n[idxH[i]])
        Hpix = jnp.linalg.inv(T2) @ H @ T1
        s, _ = _homography_score(Hpix, p1_px, p2_px, sigma2)
        return jnp.sum(jnp.where(valid, s, 0.0)), Hpix

    def hypF(i):
        F = _eight_point(p1n[idxF[i]], p2n[idxF[i]])
        Fpix = T2.T @ F @ T1
        s, _ = _fundamental_score(Fpix, p1_px, p2_px, sigma2)
        return jnp.sum(jnp.where(valid, s, 0.0)), Fpix

    sH, Hs = jax.vmap(hypH)(jnp.arange(n_hyps))
    sF, Fs = jax.vmap(hypF)(jnp.arange(n_hyps))
    bH = jnp.argmax(sH)
    bF = jnp.argmax(sF)
    SH, H = sH[bH], Hs[bH]
    SF, F = sF[bF], Fs[bF]
    _, inlH = _homography_score(H, p1_px, p2_px, sigma2)
    _, inlF = _fundamental_score(F, p1_px, p2_px, sigma2)
    use_H = SH / (SH + SF + 1e-9) > 0.40

    # --- motion hypotheses ---
    # From F: essential decomposition (4 candidates).
    E = K.T @ F @ K
    U, D, Vt = jnp.linalg.svd(E)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def fix_det(R):
        return R * jnp.sign(jnp.linalg.det(R))

    R1 = fix_det(U @ W @ Vt)
    R2 = fix_det(U @ W.T @ Vt)
    tu = U[:, 2]
    f_cands = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]

    # From H: Faugeras-style candidates via SVD of K^-1 H K.
    A = jnp.linalg.inv(K) @ H @ K
    Ua, Da, Vat = jnp.linalg.svd(A)
    d1, d2, d3 = Da[0], Da[1], Da[2]
    # principal case d1 != d2 != d3, use the +-x3 solutions (8 in full
    # Faugeras; the 4 dominant ones suffice with the check step)
    s_det = jnp.linalg.det(Ua) * jnp.linalg.det(Vat)
    x1 = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), 0, None))
    x3 = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), 0, None))
    sin_t = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0, None)) / (
        (d1 + d3) * d2 + 1e-12
    )
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    h_cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = jnp.array(
                [[cos_t, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, cos_t]]
            )
            tp = (d1 - d3) * jnp.array([e1 * x1, 0.0, -e3 * x3])
            Rc = fix_det(s_det * Ua @ Rp @ Vat)
            tc = Ua @ tp
            tc = tc / (jnp.linalg.norm(tc) + 1e-12)
            h_cands.append((Rc, tc))

    inl = jnp.where(use_H, inlH, inlF) & valid
    cands = [
        (jnp.where(use_H, hR, fR), jnp.where(use_H, ht, ft))
        for (hR, ht), (fR, ft) in zip(h_cands, f_cands)
    ]
    results = [
        _check_rt(R, t / (jnp.linalg.norm(t) + 1e-12), K, p1_px, p2_px, inl, sigma2)
        for (R, t) in cands
    ]
    goods = jnp.stack([r[0] for r in results])
    best = jnp.argmax(goods)
    n_best = goods[best]
    n_second = jnp.sort(goods)[-2]
    pts = jnp.stack([r[1] for r in results])[best]
    mask = jnp.stack([r[2] for r in results])[best]
    med_cos = jnp.stack([r[3] for r in results])[best]
    R_best = jnp.stack([c[0] for c in cands])[best]
    t_best = jnp.stack([c[1] for c in cands])[best]
    t_best = t_best / (jnp.linalg.norm(t_best) + 1e-12)

    # Accept if the winner clearly dominates, has enough support AND
    # enough parallax (the reference's CheckRT parallax>1deg rule —
    # without it a near-zero baseline initializes a garbage map).
    success = (n_best > 30) & (n_second < 0.75 * n_best) & (med_cos < 0.99985)
    return InitResult(
        success=success,
        R=R_best,
        t=t_best,
        points3d=pts,
        inliers=mask,
        used_homography=use_H,
    )
