"""Bundle adjustment with dense-block Schur complement reduction.

Static-shape JAX rebuild of Optimizer::LocalBundleAdjustment and
GlobalBundleAdjustemnt (src/Optimizer.cc, SURVEY.md §2.1 row 13, §3.3
"back-end hot loop").  The reference hands g2o a sparse graph and lets
BlockSolver_6_3 do sparse Schur; here the same math is laid out as dense
batched matmuls with static shapes:

  - per-observation residuals + Jacobians (autodiff, batched);
  - camera-diagonal blocks Hcc [C,6,6] and landmark blocks Hpp [P,3,3]
    by scatter-add (segment sum) over observations;
  - camera-landmark coupling B [P,C,6,3] by scatter-add;
  - Schur complement S = Hcc - B Hpp^-1 B^T as ONE flat matmul
    ([6C, 3P] @ [3P, 6C] — systolic-array shaped);
  - dense solve of the reduced camera system; landmark back-substitution.

Two-stage schedule mirroring the reference: 5 LM iterations with Huber,
chi2 outlier gating (5.991 mono / 7.815 stereo), 10 more without
robust kernels, final gate.

The same kernel at full capacity IS global BA; the distributed variant
shards landmarks over the mesh and psums the Schur matmul
(parallel/sharded_ba.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Normal equations in full f32: a reduced matmul precision (TF32 on the
# GPU) carries ~1e-3 relative error into the Hessian and the gradient,
# which moves the solution.
_HI = jax.lax.Precision.HIGHEST


from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .assembly import assemble, assemble_coupling, chol33, inv33, onehot_f32
from .residuals import inv_level_sigma2, make_point_residual_fn
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAResult(NamedTuple):
    R: jnp.ndarray           # [C, 3, 3]
    t: jnp.ndarray           # [C, 3]
    points: jnp.ndarray      # [P, 3]
    obs_inlier: jnp.ndarray  # bool [O]
    chi2: jnp.ndarray        # float32 scalar, final total inlier chi2


def _residuals_and_jacs(point_fn, R, t, points, obs_cam, obs_lm, obs_uvur, is_stereo):
    """Batched per-observation residual [O,3], Jc [O,3,6], Jp [O,3,3]."""
    Ro = R[obs_cam]
    to = t[obs_cam]
    po = points[obs_lm]

    def per_obs(Ri, ti, pi, oi, si):
        def f(xi, dp):
            dR, dt = se3_exp(xi)
            R2, t2 = se3_compose(dR, dt, Ri, ti)
            return point_fn(R2, t2, pi + dp, oi, si)

        zero6 = jnp.zeros(6, dtype=ti.dtype)
        zero3 = jnp.zeros(3, dtype=ti.dtype)
        r = point_fn(Ri, ti, pi, oi, si)
        Jc, Jp = jax.jacfwd(f, argnums=(0, 1))(zero6, zero3)
        return r, Jc, Jp

    return jax.vmap(per_obs)(Ro, to, po, obs_uvur, is_stereo)


@functools.partial(
    jax.jit,
    static_argnames=("cam", "scale_factor", "iters1", "iters2", "fix_first"),
)
def bundle_adjust(
    R0: jnp.ndarray,          # [C, 3, 3] world->cam
    t0: jnp.ndarray,          # [C, 3]
    cam_fixed: jnp.ndarray,   # bool [C] — poses held constant
    points0: jnp.ndarray,     # [P, 3]
    point_valid: jnp.ndarray,  # bool [P]
    obs_cam: jnp.ndarray,     # int32 [O] camera index
    obs_lm: jnp.ndarray,      # int32 [O] landmark index
    obs_uvur: jnp.ndarray,    # float32 [O, 3] (u, v, uR); uR<0 = mono
    obs_oct: jnp.ndarray,     # int32 [O]
    obs_valid: jnp.ndarray,   # bool [O]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    iters1: int = 5,
    iters2: int = 10,
    fix_first: bool = False,
) -> BAResult:
    C = R0.shape[0]
    P = points0.shape[0]
    point_fn = make_point_residual_fn(cam)

    if fix_first:
        cam_fixed = cam_fixed.at[0].set(True)

    is_stereo = obs_uvur[:, 2] > 0
    info = inv_level_sigma2(obs_oct, scale_factor)
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    obs_valid = obs_valid & point_valid[obs_lm]

    free_c = (~cam_fixed).astype(jnp.float32)[:, None]  # [C,1]
    # One-hot selection matrices for the Hessian-block assembly —
    # loop-invariant, hoisted out of the LM scan by XLA.
    oh_cam = onehot_f32(obs_cam, C)
    oh_lm = onehot_f32(obs_lm, P)

    def total_chi2(R, t, points, o_valid, use_huber):
        r = point_fn(R[obs_cam], t[obs_cam], points[obs_lm], obs_uvur, is_stereo)
        c = jnp.sum(r * r, axis=-1) * info
        w = huber_weight(c, CHI2_STEREO) if use_huber else 1.0
        return jnp.sum(jnp.where(o_valid, c * w, 0.0)), c

    def lm_iteration(carry, _, o_valid, use_huber):
        R, t, points, lam, _ = carry
        r, Jc, Jp = _residuals_and_jacs(
            point_fn, R, t, points, obs_cam, obs_lm, obs_uvur, is_stereo
        )
        c = jnp.sum(r * r, axis=-1) * info
        w = info * jnp.where(o_valid, 1.0, 0.0)
        if use_huber:
            w = w * huber_weight(c, CHI2_STEREO)

        # Weighted blocks per observation.
        JcT_Jc = jnp.einsum("odi,odj,o->oij", Jc, Jc, w, precision=_HI)     # [O,6,6]
        JpT_Jp = jnp.einsum("odi,odj,o->oij", Jp, Jp, w, precision=_HI)     # [O,3,3]
        JcT_Jp = jnp.einsum("odi,odj,o->oij", Jc, Jp, w, precision=_HI)     # [O,6,3]
        gc_o = jnp.einsum("odi,od,o->oi", Jc, r, w, precision=_HI)          # [O,6]
        gp_o = jnp.einsum("odi,od,o->oi", Jp, r, w, precision=_HI)          # [O,3]

        # Block assembly as one-hot matmuls — see backend/assembly.
        Hcc = assemble(oh_cam, JcT_Jc)
        Hpp = assemble(oh_lm, JpT_Jp)
        gc = assemble(oh_cam, gc_o)
        gp = assemble(oh_lm, gp_o)

        # LM damping.
        Hcc = Hcc + lam * Hcc * jnp.eye(6) + 1e-8 * jnp.eye(6)
        Hpp = Hpp + lam * Hpp * jnp.eye(3)
        # Safe inverse for unobserved/invalid landmarks.
        Hpp = Hpp + (1e-6 + (~point_valid[:, None, None]) * 1.0) * jnp.eye(3)
        V = inv33(Hpp)  # [P,3,3] closed-form cofactor inverse

        # Cholesky-folded coupling: with V = L L^T, the reduction
        # B V B^T = (BL)(BL)^T needs ONE [P,C,6,3] tensor instead of
        # two (B and W=BV) — L folds into the per-observation blocks
        # BEFORE assembly, and the symmetric self-contraction skips the
        # explicit [C6, P3] transposes (the two tensor copies were ~45%
        # of the iteration on-chip; tools/exp_schur2.py: 2.35 -> 1.65 ms).
        L = chol33(V)
        GL = jnp.einsum("oij,ojk->oik", JcT_Jp, L[obs_lm], precision=_HI)   # [O,6,3]
        BL = assemble_coupling(oh_lm, oh_cam, GL)            # [P,C,6,3]
        u = jnp.einsum("pji,pj->pi", L, gp, precision=_HI)                  # L^T gp
        Hcc_full = jnp.zeros((C * 6, C * 6))
        idx = jnp.arange(C)
        Hcc_full = Hcc_full.reshape(C, 6, C, 6).at[idx, :, idx, :].set(Hcc).reshape(
            C * 6, C * 6
        )
        # HIGHEST: the Schur reduction contracts over 3P (tens of
        # thousands); default bf16 injects ~0.4% noise into S for a
        # negligible saving at [6C, 3P] size.
        S = Hcc_full - jax.lax.dot_general(
            BL, BL, dimension_numbers=(((0, 3), (0, 3)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(C * 6, C * 6)
        rhs = -(gc - jnp.einsum("pcik,pk->ci", BL, u, precision=_HI)).reshape(C * 6)

        # Fixed cameras: identity rows/cols, zero rhs.
        m = jnp.repeat(free_c[:, 0], 6)  # [C6]
        S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        rhs = rhs * m

        dc = jnp.linalg.solve(S, rhs).reshape(C, 6)
        # dp = -V(gp + B^T dc); with B^T dc = L^{-T}(BL^T dc) this is
        # -(V gp + L (BL^T dc)) — no B needed.
        blt_dc = jnp.einsum("pcik,ci->pk", BL, dc, precision=_HI)
        dp = -(
            jnp.einsum("pij,pj->pi", V, gp, precision=_HI)
            + jnp.einsum("pij,pj->pi", L, blt_dc, precision=_HI)
        )
        dp = dp * point_valid[:, None]

        # Candidate update.
        dR, dt = se3_exp(dc * free_c)
        R2, t2 = jax.vmap(se3_compose)(dR, dt, R, t)
        points2 = points + dp
        # err0 from the residuals already computed this iteration (a
        # second full residual pass was ~25% of the iteration cost).
        w0 = huber_weight(c, CHI2_STEREO) if use_huber else 1.0
        err0 = jnp.sum(jnp.where(o_valid, c * w0, 0.0))
        err1, _ = total_chi2(R2, t2, points2, o_valid, use_huber)
        accept = err1 < err0
        R = jnp.where(accept, R2, R)
        t = jnp.where(accept, t2, t)
        points = jnp.where(accept, points2, points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        # Convergence streak: accepted steps whose relative chi2
        # improvement is below tol (g2o's terminate-action analog —
        # the reference's BlockSolver stops on vanishing gain too).
        rel = (err0 - err1) / jnp.maximum(err0, 1e-12)
        return (R, t, points, lam, err1), accept, rel

    def run_stage(R, t, points, o_valid, n_iters, use_huber):
        """LM stage as an early-exit while_loop: iterations after the
        chi2 gain vanishes are pure cost (measured: the 10-iteration
        stage typically converges in 4-6 on live local windows)."""
        body = functools.partial(lm_iteration, o_valid=o_valid, use_huber=use_huber)

        def cond(st):
            _, it, conv_ct = st
            return (it < n_iters) & (conv_ct < 2)

        def step(st):
            carry, it, conv_ct = st
            carry, accept, rel = body(carry, None)
            conv_ct = jnp.where(
                accept & (rel < 1e-3), conv_ct + 1, jnp.where(accept, 0, conv_ct)
            )
            return carry, it + 1, conv_ct

        init = ((R, t, points, jnp.float32(1e-4), jnp.float32(0.0)),
                jnp.int32(0), jnp.int32(0))
        (R, t, points, _, _), _, _ = jax.lax.while_loop(cond, step, init)
        return R, t, points

    # Stage 1: Huber, then gate.
    R, t, points = run_stage(R0, t0, points0, obs_valid, iters1, True)
    _, c = total_chi2(R, t, points, obs_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    # Stage 2: no robust kernel, then final gate.
    R, t, points = run_stage(R, t, points, o_valid, iters2, False)
    err, c = total_chi2(R, t, points, o_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    return BAResult(R=R, t=t, points=points, obs_inlier=o_valid, chi2=err)
