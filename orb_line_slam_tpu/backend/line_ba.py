"""Joint point+line bundle adjustment (Schur over both landmark types).

The reference's LocalBundleAdjustment includes MapLine vertices with
Plücker/orthonormal 4-DoF updates alongside point vertices
(arXiv:1711.08654 §III-C; SURVEY.md §2.1 rows 8, 13).  This solver
extends backend/local_ba.py's dense-block Schur reduction with line
landmarks:

  - line residual: perpendicular distances of the observed segment's
    two endpoints to the PROJECTED infinite line l = K_L n_c (2-DoF);
  - line blocks: Hll [L,4,4], coupling Bl [L,C,6,4] — eliminated
    exactly like the 3x3 point blocks, folding into the SAME reduced
    camera system:
        S = Hcc - Bp Vp Bp^T - Bl Vl Bl^T
  - line update: orthonormal retraction (U exp([th]x), rot(phi) w).

Point math is shared with local_ba (_residuals_and_jacs).
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
from ..geometry.lines3d import (
    line_projection_matrix,
    orthonormal_retract,
    pluecker_from_orthonormal,
    pluecker_transform,
)
from ..geometry.se3 import se3_compose, se3_exp
from .assembly import (
    assemble, assemble_coupling, chol33, chol44, inv33, inv44, onehot_f32,
)
from .local_ba import _residuals_and_jacs
from .residuals import inv_level_sigma2, make_point_residual_fn
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PLBAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    points: jnp.ndarray
    line_U: jnp.ndarray        # [L, 3, 3]
    line_w: jnp.ndarray        # [L, 2]
    obs_inlier: jnp.ndarray    # bool [O] point observations
    lobs_inlier: jnp.ndarray   # bool [Ol] line observations
    chi2: jnp.ndarray


def _line_residual_fn(cam: CameraIntrinsics):
    KL = line_projection_matrix(cam.fx, cam.fy, cam.cx, cam.cy)

    def fn(R, t, U, w, obs_a, obs_b):
        n_w, v_w = pluecker_from_orthonormal(U, w)
        n_c, _ = pluecker_transform(R, t, n_w, v_w)
        l = jnp.matmul(KL, n_c, precision=_HI)
        norm = jnp.sqrt(l[0] ** 2 + l[1] ** 2 + 1e-12)
        d_a = (l[0] * obs_a[0] + l[1] * obs_a[1] + l[2]) / norm
        d_b = (l[0] * obs_b[0] + l[1] * obs_b[1] + l[2]) / norm
        return jnp.stack([d_a, d_b])

    return fn


def _line_res_jacs(line_fn, R, t, U, w, lobs_cam, lobs_ln, lobs_a, lobs_b):
    Ro = R[lobs_cam]
    to = t[lobs_cam]
    Uo = U[lobs_ln]
    wo = w[lobs_ln]

    def per_obs(Ri, ti, Ui, wi, ai, bi):
        def f(xi_c, xi_l):
            dR, dt = se3_exp(xi_c)
            R2, t2 = se3_compose(dR, dt, Ri, ti)
            U2, w2 = orthonormal_retract(Ui, wi, xi_l)
            return line_fn(R2, t2, U2, w2, ai, bi)

        z6 = jnp.zeros(6)
        z4 = jnp.zeros(4)
        r = line_fn(Ri, ti, Ui, wi, ai, bi)
        Jc, Jl = jax.jacfwd(f, argnums=(0, 1))(z6, z4)
        return r, Jc, Jl

    return jax.vmap(per_obs)(Ro, to, Uo, wo, lobs_a, lobs_b)


# Fixed-point pixel quantum for packed observations: 1/16 px, far below
# the ~0.3 px detector noise the solver already absorbs.
_UV_Q = 16.0
# uR rides with a +32 px offset so the mono sentinel (-1) stays positive.
_UR_OFF = 32.0


def pack_pl_inputs(pack, lpack, U0, w0, lval):
    """Flatten every bundle_adjust_pl input into ONE uint32 buffer.

    One buffer + a device-side unpack is a single host-to-device
    transfer instead of ~20 separate jnp.asarray uploads.  Observations pack to 3 words each (code word:
    cam 5 bits | lm 14 | oct 3 | valid 1; u,v and uR as 1/16-px
    fixed point) — the obs block dominates the buffer and uplink runs
    ~30 MB/s.  Layout mirrors bundle_adjust_pl_flat's unpack — both
    derive offsets from the same static (C, P, O, L, Ol)."""
    import numpy as np

    u = lambda a: np.ascontiguousarray(a).view(np.uint32).ravel()  # noqa: E731
    b = lambda a: a.astype(np.uint32).ravel()  # noqa: E731

    code = (
        pack["obs_cam"].astype(np.uint32)
        | (pack["obs_lm"].astype(np.uint32) << 5)
        | (np.clip(pack["obs_oct"], 0, 7).astype(np.uint32) << 19)
        | (pack["obs_valid"].astype(np.uint32) << 22)
    )
    uv = np.clip(pack["obs_uvur"][:, :2] * _UV_Q, 0, 65535).astype(np.uint32)
    uv_w = uv[:, 0] | (uv[:, 1] << 16)
    ur_w = np.clip(
        (pack["obs_uvur"][:, 2] + _UR_OFF) * _UV_Q, 0, 65535
    ).astype(np.uint32)

    lcode = (
        lpack["lobs_cam"].astype(np.uint32)
        | (lpack["lobs_ln"].astype(np.uint32) << 5)
        | (lpack["lobs_valid"].astype(np.uint32) << 22)
    )
    la = np.clip(lpack["lobs_a"] * _UV_Q, 0, 65535).astype(np.uint32)
    lb = np.clip(lpack["lobs_b"] * _UV_Q, 0, 65535).astype(np.uint32)
    parts = [
        u(pack["R"].astype(np.float32)), u(pack["t"].astype(np.float32)),
        b(pack["cam_fixed"]),
        u(pack["points"].astype(np.float32)), b(pack["point_valid"]),
        code, uv_w, ur_w,
        u(U0.astype(np.float32)), u(w0.astype(np.float32)), b(lval),
        lcode, la[:, 0] | (la[:, 1] << 16), lb[:, 0] | (lb[:, 1] << 16),
    ]
    return np.concatenate(parts)


@functools.partial(
    jax.jit, static_argnames=("C", "P", "O", "L", "Ol", "cam", "scale_factor")
)
def bundle_adjust_pl_flat(flat, C, P, O, L, Ol, cam, scale_factor=1.2):
    """bundle_adjust_pl on a single packed uint32 input buffer."""
    off = [0]

    def take(n):
        v = jax.lax.dynamic_slice(flat, (off[0],), (n,))
        off[0] += n
        return v

    f = lambda v, *s: jax.lax.bitcast_convert_type(v, jnp.float32).reshape(*s)  # noqa: E731
    bb = lambda v: v > 0  # noqa: E731
    R = f(take(C * 9), C, 3, 3)
    t = f(take(C * 3), C, 3)
    cam_fixed = bb(take(C))
    points = f(take(P * 3), P, 3)
    point_valid = bb(take(P))
    code = take(O)
    obs_cam = (code & 0x1F).astype(jnp.int32)
    obs_lm = ((code >> 5) & 0x3FFF).astype(jnp.int32)
    obs_oct = ((code >> 19) & 0x7).astype(jnp.int32)
    obs_valid = ((code >> 22) & 1) > 0
    uv_w = take(O)
    ur_w = take(O)
    q = jnp.float32(1.0 / _UV_Q)
    obs_uvur = jnp.stack(
        [
            (uv_w & 0xFFFF).astype(jnp.float32) * q,
            (uv_w >> 16).astype(jnp.float32) * q,
            ur_w.astype(jnp.float32) * q - _UR_OFF,
        ],
        axis=-1,
    )
    U0 = f(take(L * 9), L, 3, 3)
    w0 = f(take(L * 2), L, 2)
    lval = bb(take(L))
    lcode = take(Ol)
    lobs_cam = (lcode & 0x1F).astype(jnp.int32)
    lobs_ln = ((lcode >> 5) & 0x3FFF).astype(jnp.int32)
    lobs_valid = ((lcode >> 22) & 1) > 0
    la_w = take(Ol)
    lb_w = take(Ol)
    lobs_a = jnp.stack(
        [(la_w & 0xFFFF).astype(jnp.float32) * q,
         (la_w >> 16).astype(jnp.float32) * q], axis=-1,
    )
    lobs_b = jnp.stack(
        [(lb_w & 0xFFFF).astype(jnp.float32) * q,
         (lb_w >> 16).astype(jnp.float32) * q], axis=-1,
    )
    res = bundle_adjust_pl.__wrapped__(
        R, t, cam_fixed, points, point_valid,
        obs_cam, obs_lm, obs_uvur, obs_oct, obs_valid,
        U0, w0, lval,
        lobs_cam, lobs_ln, lobs_a, lobs_b,
        jnp.zeros(Ol, jnp.int32), lobs_valid,
        cam, scale_factor,
    )
    # Flatten the result INSIDE this program: fused here it costs no
    # separate packing dispatch.
    flat_out = jnp.concatenate(
        [jnp.asarray(l, jnp.float32).ravel()
         for l in jax.tree_util.tree_leaves(res)]
    )
    return res, flat_out


def pl_result_layout(C, P, O, L, Ol):
    """(treedef, shapes) of PLBAResult for host-side unpacking of the
    fused flat result (mirrors PLBAResult field order)."""
    import numpy as np

    proto = PLBAResult(
        R=np.zeros((C, 3, 3), np.float32), t=np.zeros((C, 3), np.float32),
        points=np.zeros((P, 3), np.float32),
        line_U=np.zeros((L, 3, 3), np.float32),
        line_w=np.zeros((L, 2), np.float32),
        obs_inlier=np.zeros(O, bool), lobs_inlier=np.zeros(Ol, bool),
        chi2=np.float32(0.0),
    )
    leaves, treedef = jax.tree_util.tree_flatten(proto)
    shapes = [(tuple(np.shape(l)), np.dtype(np.asarray(l).dtype)) for l in leaves]
    return treedef, shapes


@functools.partial(
    jax.jit,
    static_argnames=("cam", "scale_factor", "iters1", "iters2"),
)
def bundle_adjust_pl(
    R0, t0, cam_fixed,
    points0, point_valid,
    obs_cam, obs_lm, obs_uvur, obs_oct, obs_valid,
    line_U0, line_w0, line_valid,          # [L,3,3], [L,2], [L]
    lobs_cam, lobs_ln, lobs_a, lobs_b,     # [Ol], [Ol], [Ol,2], [Ol,2]
    lobs_oct, lobs_valid,                  # [Ol]
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    iters1: int = 5,
    iters2: int = 10,
) -> PLBAResult:
    C = R0.shape[0]
    P = points0.shape[0]
    L = line_U0.shape[0]
    point_fn = make_point_residual_fn(cam)
    line_fn = _line_residual_fn(cam)

    is_stereo = obs_uvur[:, 2] > 0
    p_info = inv_level_sigma2(obs_oct, scale_factor)
    l_info = inv_level_sigma2(lobs_oct, scale_factor)
    chi2_th_p = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    obs_valid = obs_valid & point_valid[obs_lm]
    lobs_valid = lobs_valid & line_valid[lobs_ln]
    free_c = (~cam_fixed).astype(jnp.float32)[:, None]
    # One-hot assembly matrices (loop-invariant; hoisted out of the scan).
    oh_cam = onehot_f32(obs_cam, C)
    oh_lm = onehot_f32(obs_lm, P)
    oh_lcam = onehot_f32(lobs_cam, C)
    oh_ln = onehot_f32(lobs_ln, L)

    def total_chi2(R, t, points, U, w, ov, lov, use_huber):
        r = point_fn(R[obs_cam], t[obs_cam], points[obs_lm], obs_uvur, is_stereo)
        c_p = jnp.sum(r * r, -1) * p_info
        rl = jax.vmap(line_fn)(
            R[lobs_cam], t[lobs_cam], U[lobs_ln], w[lobs_ln], lobs_a, lobs_b
        )
        c_l = jnp.sum(rl * rl, -1) * l_info
        w_p = huber_weight(c_p, CHI2_STEREO) if use_huber else 1.0
        w_l = huber_weight(c_l, CHI2_MONO) if use_huber else 1.0
        return (
            jnp.sum(jnp.where(ov, c_p * w_p, 0.0))
            + jnp.sum(jnp.where(lov, c_l * w_l, 0.0)),
            c_p,
            c_l,
        )

    def lm_iteration(carry, _, ov, lov, use_huber):
        R, t, points, U, w, lam = carry
        # ---- point blocks (same math as local_ba) ----
        r, Jc, Jp = _residuals_and_jacs(
            point_fn, R, t, points, obs_cam, obs_lm, obs_uvur, is_stereo
        )
        c_p = jnp.sum(r * r, -1) * p_info
        wgt = p_info * jnp.where(ov, 1.0, 0.0)
        if use_huber:
            wgt = wgt * huber_weight(c_p, CHI2_STEREO)
        JcT_Jc = jnp.einsum("odi,odj,o->oij", Jc, Jc, wgt, precision=_HI)
        JpT_Jp = jnp.einsum("odi,odj,o->oij", Jp, Jp, wgt, precision=_HI)
        JcT_Jp = jnp.einsum("odi,odj,o->oij", Jc, Jp, wgt, precision=_HI)
        gc_o = jnp.einsum("odi,od,o->oi", Jc, r, wgt, precision=_HI)
        gp_o = jnp.einsum("odi,od,o->oi", Jp, r, wgt, precision=_HI)
        Hcc = assemble(oh_cam, JcT_Jc)
        Hpp = assemble(oh_lm, JpT_Jp)
        gc = assemble(oh_cam, gc_o)
        gp = assemble(oh_lm, gp_o)

        # ---- line blocks ----
        rl, Jlc, Jll = _line_res_jacs(
            line_fn, R, t, U, w, lobs_cam, lobs_ln, lobs_a, lobs_b
        )
        c_l = jnp.sum(rl * rl, -1) * l_info
        lw = l_info * jnp.where(lov, 1.0, 0.0)
        if use_huber:
            lw = lw * huber_weight(c_l, CHI2_MONO)
        JlcT_Jlc = jnp.einsum("odi,odj,o->oij", Jlc, Jlc, lw, precision=_HI)
        JllT_Jll = jnp.einsum("odi,odj,o->oij", Jll, Jll, lw, precision=_HI)
        JlcT_Jll = jnp.einsum("odi,odj,o->oij", Jlc, Jll, lw, precision=_HI)
        glc_o = jnp.einsum("odi,od,o->oi", Jlc, rl, lw, precision=_HI)
        gll_o = jnp.einsum("odi,od,o->oi", Jll, rl, lw, precision=_HI)
        Hcc = Hcc + assemble(oh_lcam, JlcT_Jlc)
        Hll = assemble(oh_ln, JllT_Jll)
        gc = gc + assemble(oh_lcam, glc_o)
        gl = assemble(oh_ln, gll_o)

        # ---- damping + eliminations ----
        Hcc = Hcc + lam * Hcc * jnp.eye(6) + 1e-8 * jnp.eye(6)
        Hpp = Hpp + lam * Hpp * jnp.eye(3)
        Hpp = Hpp + (1e-6 + (~point_valid[:, None, None]) * 1.0) * jnp.eye(3)
        Vp = inv33(Hpp)
        Hll = Hll + lam * Hll * jnp.eye(4)
        Hll = Hll + (1e-5 + (~line_valid[:, None, None]) * 1.0) * jnp.eye(4)
        Vl = inv44(Hll)

        # Cholesky-folded couplings (see local_ba.py): one [.,C,6,k]
        # tensor per landmark type, symmetric Schur self-products.
        Lp = chol33(Vp)
        Ll = chol44(Vl)
        GLp = jnp.einsum("oij,ojk->oik", JcT_Jp, Lp[obs_lm], precision=_HI)
        GLl = jnp.einsum("oij,ojk->oik", JlcT_Jll, Ll[lobs_ln], precision=_HI)
        BLp = assemble_coupling(oh_lm, oh_cam, GLp)     # [P,C,6,3]
        BLl = assemble_coupling(oh_ln, oh_lcam, GLl)    # [L,C,6,4]
        up = jnp.einsum("pji,pj->pi", Lp, gp, precision=_HI)
        ul = jnp.einsum("lji,lj->li", Ll, gl, precision=_HI)
        idx = jnp.arange(C)
        Hcc_full = (
            jnp.zeros((C, 6, C, 6)).at[idx, :, idx, :].set(Hcc).reshape(C * 6, C * 6)
        )
        contract = lambda X: jax.lax.dot_general(  # noqa: E731
            X, X, dimension_numbers=(((0, 3), (0, 3)), ((), ())),
            preferred_element_type=jnp.float32, precision=_HI,
        ).reshape(C * 6, C * 6)
        S = Hcc_full - contract(BLp) - contract(BLl)
        rhs = -(
            gc
            - jnp.einsum("pcik,pk->ci", BLp, up, precision=_HI)
            - jnp.einsum("lcik,lk->ci", BLl, ul, precision=_HI)
        ).reshape(C * 6)

        m = jnp.repeat(free_c[:, 0], 6)
        S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        rhs = rhs * m
        dc = jnp.linalg.solve(S, rhs).reshape(C, 6)

        dp = -(
            jnp.einsum("pij,pj->pi", Vp, gp, precision=_HI)
            + jnp.einsum("pij,pj->pi", Lp, jnp.einsum("pcik,ci->pk", BLp, dc, precision=_HI),
                         precision=_HI)
        )
        dp = dp * point_valid[:, None]
        dl = -(
            jnp.einsum("lij,lj->li", Vl, gl, precision=_HI)
            + jnp.einsum("lij,lj->li", Ll, jnp.einsum("lcik,ci->lk", BLl, dc, precision=_HI),
                         precision=_HI)
        )
        dl = dl * line_valid[:, None]

        dR, dt = se3_exp(dc * free_c)
        R2, t2 = jax.vmap(se3_compose)(dR, dt, R, t)
        points2 = points + dp
        U2, w2 = orthonormal_retract(U, w, dl)
        # err0 from this iteration's residuals (saves a full pass).
        wp0 = huber_weight(c_p, CHI2_STEREO) if use_huber else 1.0
        wl0 = huber_weight(c_l, CHI2_MONO) if use_huber else 1.0
        err0 = jnp.sum(jnp.where(ov, c_p * wp0, 0.0)) + jnp.sum(
            jnp.where(lov, c_l * wl0, 0.0)
        )
        err1, _, _ = total_chi2(R2, t2, points2, U2, w2, ov, lov, use_huber)
        accept = err1 < err0
        R = jnp.where(accept, R2, R)
        t = jnp.where(accept, t2, t)
        points = jnp.where(accept, points2, points)
        U = jnp.where(accept, U2, U)
        w = jnp.where(accept, w2, w)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        rel = (err0 - err1) / jnp.maximum(err0, 1e-12)
        return (R, t, points, U, w, lam), accept, rel

    def run_stage(R, t, points, U, w, ov, lov, n_iters, use_huber):
        """Early-exit LM stage (see local_ba.run_stage): stop after two
        consecutive accepted steps with <0.1% chi2 gain."""
        body = functools.partial(lm_iteration, ov=ov, lov=lov, use_huber=use_huber)

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

        init = ((R, t, points, U, w, jnp.float32(1e-4)), jnp.int32(0), jnp.int32(0))
        (R, t, points, U, w, _), _, _ = jax.lax.while_loop(cond, step, init)
        return R, t, points, U, w

    R, t, points, U, w = run_stage(
        R0, t0, points0, line_U0, line_w0, obs_valid, lobs_valid, iters1, True
    )
    _, c_p, c_l = total_chi2(R, t, points, U, w, obs_valid, lobs_valid, False)
    ov = obs_valid & (c_p <= chi2_th_p)
    lov = lobs_valid & (c_l <= CHI2_MONO)
    R, t, points, U, w = run_stage(R, t, points, U, w, ov, lov, iters2, False)
    err, c_p, c_l = total_chi2(R, t, points, U, w, ov, lov, False)
    ov = obs_valid & (c_p <= chi2_th_p)
    lov = lobs_valid & (c_l <= CHI2_MONO)
    return PLBAResult(
        R=R, t=t, points=points, line_U=U, line_w=w,
        obs_inlier=ov, lobs_inlier=lov, chi2=err,
    )
