"""Motion-only bundle adjustment (the per-frame pose solve).

Static-shape JAX rebuild of Optimizer::PoseOptimization (src/Optimizer.cc,
SURVEY.md §2.1 row 13, §3.2 "hot loop 5"): one free SE3 vertex, unary
point edges (mono + stereo) and optional line edges; 4 rounds of 10 LM
iterations with chi2 outlier gating between rounds (5.991 mono /
7.815 stereo), Huber kernels on the first two rounds only — the same
schedule the reference hardcodes.

The normal equations are 6x6: H = sum_i w_i J_i^T S_i J_i accumulated
with one batched einsum, solved densely.  The whole optimizer
is a single jitted program with static iteration counts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .residuals import (
    inv_level_sigma2,
    make_line_residual_fn,
    make_point_residual_fn,
    pose_jacobian,
)
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray       # bool [M] point inliers
    line_inliers: jnp.ndarray  # bool [L]
    n_inliers: jnp.ndarray     # int32 scalar (points + lines)


def _residuals_all(cam, R, t, pts, obs, is_stereo, lps, lpe, lobs):
    pr = make_point_residual_fn(cam)(R, t, pts, obs, is_stereo)
    lr = make_line_residual_fn(cam)(R, t, lps, lpe, lobs)
    return pr, lr


def _chi2(pr, lr, p_info, l_info):
    c_p = jnp.sum(pr * pr, axis=-1) * p_info
    c_l = jnp.sum(lr * lr, axis=-1) * l_info
    return c_p, c_l


@functools.partial(
    jax.jit, static_argnames=("cam", "scale_factor", "rounds", "iters")
)
def pose_optimize(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    points_w: jnp.ndarray,     # [M, 3]
    obs_uvur: jnp.ndarray,     # [M, 3] (u, v, uR); uR < 0 => mono
    octave: jnp.ndarray,       # [M]
    valid: jnp.ndarray,        # [M]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    line_start_w: jnp.ndarray | None = None,  # [L, 3]
    line_end_w: jnp.ndarray | None = None,    # [L, 3]
    line_obs: jnp.ndarray | None = None,      # [L, 3] (a,b,c) normalized
    line_octave: jnp.ndarray | None = None,   # [L]
    line_valid: jnp.ndarray | None = None,    # [L]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    M = points_w.shape[0]
    if line_start_w is None:
        L = 8
        line_start_w = jnp.zeros((L, 3))
        line_end_w = jnp.ones((L, 3))
        line_obs = jnp.concatenate([jnp.ones((L, 2)) * 0.707, jnp.zeros((L, 1))], -1)
        line_octave = jnp.zeros((L,), jnp.int32)
        line_valid = jnp.zeros((L,), bool)
    L = line_start_w.shape[0]

    is_stereo = obs_uvur[:, 2] > 0
    p_info = inv_level_sigma2(octave, scale_factor)
    l_info = inv_level_sigma2(line_octave, scale_factor)
    chi2_th_p = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    point_fn = make_point_residual_fn(cam)
    line_fn = make_line_residual_fn(cam)

    def lm_round(R, t, p_in, l_in, use_huber: bool):
        def body(carry, _):
            R, t, lam = carry
            pr, Jp = pose_jacobian(point_fn, R, t, points_w, obs_uvur, is_stereo)
            lr, Jl = pose_jacobian(line_fn, R, t, line_start_w, line_end_w, line_obs)
            c_p, c_l = _chi2(pr, lr, p_info, l_info)
            if use_huber:
                w_p = huber_weight(c_p, CHI2_STEREO) * p_info
                w_l = huber_weight(c_l, CHI2_MONO) * l_info
            else:
                w_p = p_info
                w_l = l_info
            w_p = jnp.where(p_in, w_p, 0.0)
            w_l = jnp.where(l_in, w_l, 0.0)

            # HIGHEST: the 6x6 normal equations contract over thousands
            # of observations — a reduced default matmul precision (bf16,
            # or TF32 on the GPU) injects noise into H for zero savings
            # at this size.
            hp = jax.lax.Precision.HIGHEST
            H = jnp.einsum("mdi,mdj,m->ij", Jp, Jp, w_p, precision=hp) + jnp.einsum(
                "ldi,ldj,l->ij", Jl, Jl, w_l, precision=hp
            )
            g = jnp.einsum("mdi,md,m->i", Jp, pr, w_p, precision=hp) + jnp.einsum(
                "ldi,ld,l->i", Jl, lr, w_l, precision=hp
            )
            err0 = jnp.sum(jnp.where(p_in, c_p * jnp.where(use_huber, huber_weight(c_p, CHI2_STEREO), 1.0), 0.0)) + jnp.sum(
                jnp.where(l_in, c_l, 0.0)
            )

            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6)
            xi = -jnp.linalg.solve(Hd, g)
            dR, dt = se3_exp(xi)
            R2, t2 = se3_compose(dR, dt, R, t)

            pr2 = point_fn(R2, t2, points_w, obs_uvur, is_stereo)
            lr2 = line_fn(R2, t2, line_start_w, line_end_w, line_obs)
            c_p2, c_l2 = _chi2(pr2, lr2, p_info, l_info)
            err1 = jnp.sum(jnp.where(p_in, c_p2 * jnp.where(use_huber, huber_weight(c_p2, CHI2_STEREO), 1.0), 0.0)) + jnp.sum(
                jnp.where(l_in, c_l2, 0.0)
            )

            accept = err1 < err0
            R = jnp.where(accept, R2, R)
            t = jnp.where(accept, t2, t)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam = jnp.clip(lam, 1e-9, 1e6)
            return (R, t, lam), None

        (R, t, _), _ = jax.lax.scan(body, (R, t, jnp.float32(1e-3)), None, length=iters)
        return R, t

    R, t = R0, t0
    p_in = valid
    l_in = line_valid
    for rnd in range(rounds):
        R, t = lm_round(R, t, p_in, l_in, use_huber=(rnd < 2))
        pr = point_fn(R, t, points_w, obs_uvur, is_stereo)
        lr = line_fn(R, t, line_start_w, line_end_w, line_obs)
        c_p, c_l = _chi2(pr, lr, p_info, l_info)
        p_in = valid & (c_p <= chi2_th_p)
        l_in = line_valid & (c_l <= CHI2_MONO)

    n_in = jnp.sum(p_in.astype(jnp.int32)) + jnp.sum(l_in.astype(jnp.int32))
    return PoseOptResult(R=R, t=t, inliers=p_in, line_inliers=l_in, n_inliers=n_in)
