"""Distributed bundle adjustment: landmark-sharded Schur reduction.

The reference has no distributed anything (single process + pthreads,
SURVEY.md §2.4); this module is the multi-device scaling path demanded by
BASELINE.json:5/11: keyframes are replicated, landmarks and their
observations are sharded over a `jax.sharding.Mesh` axis, and each
device computes the partial camera Hessian + Schur contribution of its
landmark block.  One `psum` over the mesh assembles the reduced camera
system (the Hessian crosses the interconnect, never the raw
observations); every
device solves the small replicated camera system and back-substitutes
its own landmark shard locally.

    S = psum_d( Hcc_d - B_d Hpp_d^-1 B_d^T ),   dc = S^-1 rhs (replicated)
    dp_d = -Hpp_d^-1 (gp_d + B_d^T dc)          (local, no comm)

Math mirrors backend/local_ba.py (same residuals/weights/gating).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Normal equations in full f32: a reduced matmul precision (TF32 on the
# GPU) carries ~1e-3 relative error into the Hessian and the gradient,
# which moves the solution.
_HI = jax.lax.Precision.HIGHEST

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend.assembly import inv33
from ..backend.local_ba import _residuals_and_jacs
from ..backend.residuals import inv_level_sigma2, make_point_residual_fn
from ..backend.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from ..geometry.se3 import se3_compose, se3_exp


def _ba_shard_body(
    R, t, cam_fixed, points, point_valid,
    obs_cam, obs_lm_local, obs_uvur, obs_oct, obs_valid,
    cam, scale_factor, n_iters, axis_name,
):
    """LM loop over one landmark shard; obs_lm_local indexes into the
    LOCAL points shard. Runs inside shard_map with `axis_name`."""
    C = R.shape[0]
    Pl = points.shape[0]
    point_fn = make_point_residual_fn(cam)
    is_stereo = obs_uvur[:, 2] > 0
    info = inv_level_sigma2(obs_oct, scale_factor)
    obs_valid = obs_valid & point_valid[obs_lm_local]
    free_c = (~cam_fixed).astype(jnp.float32)[:, None]

    def total_chi2(R, t, points, use_huber):
        r = point_fn(R[obs_cam], t[obs_cam], points[obs_lm_local], obs_uvur, is_stereo)
        c = jnp.sum(r * r, axis=-1) * info
        w = huber_weight(c, CHI2_STEREO) if use_huber else 1.0
        local = jnp.sum(jnp.where(obs_valid, c * w, 0.0))
        return jax.lax.psum(local, axis_name)

    def body(carry, _):
        R, t, points, lam = carry
        r, Jc, Jp = _residuals_and_jacs(
            point_fn, R, t, points, obs_cam, obs_lm_local, obs_uvur, is_stereo
        )
        c = jnp.sum(r * r, axis=-1) * info
        w = info * huber_weight(c, CHI2_STEREO) * jnp.where(obs_valid, 1.0, 0.0)

        JcT_Jc = jnp.einsum("odi,odj,o->oij", Jc, Jc, w, precision=_HI)
        JpT_Jp = jnp.einsum("odi,odj,o->oij", Jp, Jp, w, precision=_HI)
        JcT_Jp = jnp.einsum("odi,odj,o->oij", Jc, Jp, w, precision=_HI)
        gc_o = jnp.einsum("odi,od,o->oi", Jc, r, w, precision=_HI)
        gp_o = jnp.einsum("odi,od,o->oi", Jp, r, w, precision=_HI)

        Hcc = jnp.zeros((C, 6, 6)).at[obs_cam].add(JcT_Jc)
        Hpp = jnp.zeros((Pl, 3, 3)).at[obs_lm_local].add(JpT_Jp)
        B = (
            jnp.zeros((Pl * C, 18))
            .at[obs_lm_local * C + obs_cam]
            .add(JcT_Jp.reshape(-1, 18))
            .reshape(Pl, C, 6, 3)
        )
        gc = jnp.zeros((C, 6)).at[obs_cam].add(gc_o)
        gp = jnp.zeros((Pl, 3)).at[obs_lm_local].add(gp_o)

        Hcc = Hcc + lam * Hcc * jnp.eye(6)
        Hpp = Hpp + lam * Hpp * jnp.eye(3)
        Hpp = Hpp + (1e-6 + (~point_valid[:, None, None]) * 1.0) * jnp.eye(3)
        V = inv33(Hpp)
        Wp = jnp.einsum("pcij,pjk->pcik", B, V, precision=_HI)

        A1 = Wp.transpose(1, 2, 0, 3).reshape(C * 6, Pl * 3)
        A2 = B.transpose(1, 2, 0, 3).reshape(C * 6, Pl * 3)
        idx = jnp.arange(C)
        Hcc_full = (
            jnp.zeros((C, 6, C, 6)).at[idx, :, idx, :].set(Hcc).reshape(C * 6, C * 6)
        )
        S_local = Hcc_full - jnp.dot(
            A1, A2.T, preferred_element_type=jnp.float32, precision=_HI
        )
        rhs_local = -(gc - jnp.einsum("pcik,pk->ci", Wp, gp, precision=_HI)).reshape(C * 6)

        # The ONLY cross-device communication: reduce the camera system.
        S = jax.lax.psum(S_local, axis_name)
        rhs = jax.lax.psum(rhs_local, axis_name)
        S = S + 1e-8 * jnp.eye(C * 6)

        m = jnp.repeat(free_c[:, 0], 6)
        S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        rhs = rhs * m
        dc = jnp.linalg.solve(S, rhs).reshape(C, 6)

        dp = -jnp.einsum(
            "pij,pj->pi", V, gp + jnp.einsum("pcij,ci->pj", B, dc, precision=_HI),
            precision=_HI,
        )
        dp = dp * point_valid[:, None]

        dR, dt = se3_exp(dc * free_c)
        R2, t2 = jax.vmap(se3_compose)(dR, dt, R, t)
        points2 = points + dp
        err0 = total_chi2(R, t, points, True)
        err1 = total_chi2(R2, t2, points2, True)
        accept = err1 < err0
        R = jnp.where(accept, R2, R)
        t = jnp.where(accept, t2, t)
        points = jnp.where(accept, points2, points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        return (R, t, points, lam), None

    (R, t, points, _), _ = jax.lax.scan(
        body, (R, t, points, jnp.float32(1e-4)), None, length=n_iters
    )
    return R, t, points


def _cg_shard_body(
    R, t, cam_fixed, points, point_valid,
    obs_cam, obs_lm_local, obs_uvur, obs_oct, obs_valid,
    cam, scale_factor, iters1, iters2, cg_iters, axis_name,
):
    """Landmark-sharded matrix-free CG-on-Schur LM (the distributed
    variant of backend/global_ba.bundle_adjust_cg): landmarks, their
    Hpp blocks and observations live per shard; the reduced camera
    system is never materialized — each CG step does ONE psum of a
    [C,6] vector (plus one [C,6,6]+[C,6] psum per LM iteration for the
    diagonal blocks/gradient), so the wire traffic per iteration is
    O(C) regardless of landmark count.  This is the 'reduce camera
    Hessian over the interconnect' recipe of SURVEY.md §2.4 /
    BASELINE.json:5."""
    C = R.shape[0]
    Pl = points.shape[0]
    point_fn = make_point_residual_fn(cam)
    is_stereo = obs_uvur[:, 2] > 0
    info = inv_level_sigma2(obs_oct, scale_factor)
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    obs_valid = obs_valid & point_valid[obs_lm_local]
    free_c = (~cam_fixed).astype(jnp.float32)[:, None]
    m = free_c[:, 0]

    def total_chi2(R, t, points, o_valid, use_huber):
        r = point_fn(R[obs_cam], t[obs_cam], points[obs_lm_local], obs_uvur,
                     is_stereo)
        c = jnp.sum(r * r, axis=-1) * info
        w = huber_weight(c, CHI2_STEREO) if use_huber else 1.0
        return jax.lax.psum(jnp.sum(jnp.where(o_valid, c * w, 0.0)), axis_name), c

    def lm_iteration(carry, _, o_valid, use_huber):
        R, t, points, lam = carry
        r, Jc, Jp = _residuals_and_jacs(
            point_fn, R, t, points, obs_cam, obs_lm_local, obs_uvur, is_stereo
        )
        c = jnp.sum(r * r, axis=-1) * info
        w = info * jnp.where(o_valid, 1.0, 0.0)
        if use_huber:
            w = w * huber_weight(c, CHI2_STEREO)

        JcT_Jc = jnp.einsum("odi,odj,o->oij", Jc, Jc, w, precision=_HI)
        JpT_Jp = jnp.einsum("odi,odj,o->oij", Jp, Jp, w, precision=_HI)
        JcT_Jp = jnp.einsum("odi,odj,o->oij", Jc, Jp, w, precision=_HI)
        gc_o = jnp.einsum("odi,od,o->oi", Jc, r, w, precision=_HI)
        gp_o = jnp.einsum("odi,od,o->oi", Jp, r, w, precision=_HI)

        # Camera blocks: local partials reduced over the mesh.
        Hcc = jax.lax.psum(
            jnp.zeros((C, 6, 6)).at[obs_cam].add(JcT_Jc), axis_name
        )
        gc = jax.lax.psum(jnp.zeros((C, 6)).at[obs_cam].add(gc_o), axis_name)
        # Landmark blocks: shard-local, no communication.
        Hpp = jnp.zeros((Pl, 3, 3)).at[obs_lm_local].add(JpT_Jp)
        gp = jnp.zeros((Pl, 3)).at[obs_lm_local].add(gp_o)

        Hcc = Hcc + lam * Hcc * jnp.eye(6) + 1e-8 * jnp.eye(6)
        Hpp = Hpp + lam * Hpp * jnp.eye(3)
        Hpp = Hpp + (1e-6 + (~point_valid[:, None, None]) * 1.0) * jnp.eye(3)
        V = inv33(Hpp)

        def bt_x(x):
            yo = jnp.einsum("oij,oi->oj", JcT_Jp, x[obs_cam], precision=_HI)
            return jnp.zeros((Pl, 3)).at[obs_lm_local].add(yo)

        def b_z(z):
            uo = jnp.einsum("oij,oj->oi", JcT_Jp, z[obs_lm_local], precision=_HI)
            return jax.lax.psum(
                jnp.zeros((C, 6)).at[obs_cam].add(uo), axis_name
            )

        def s_matvec(x):
            xm = x * m[:, None]
            hx = jnp.einsum("cij,cj->ci", Hcc, xm, precision=_HI)
            z = jnp.einsum("pij,pj->pi", V, bt_x(xm), precision=_HI)
            sx = (hx - b_z(z)) * m[:, None]
            return sx + x * (1.0 - m)[:, None]

        rhs = -(gc - b_z(jnp.einsum("pij,pj->pi", V, gp, precision=_HI))) * m[:, None]
        Minv = jnp.linalg.inv(Hcc + 1e-6 * jnp.eye(6))

        def precond(v):
            return jnp.einsum("cij,cj->ci", Minv, v * m[:, None], precision=_HI) * m[:, None] \
                + v * (1.0 - m)[:, None]

        def cg_step(state, _):
            x, rr, p, rz = state
            Ap = s_matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(pAp > 1e-20, rz / pAp, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(rz > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, rr, p, rz_new), None

        x0 = jnp.zeros_like(rhs)
        z0 = precond(rhs)
        (dc, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, rhs, z0, jnp.sum(rhs * z0)), None, length=cg_iters
        )
        dc = dc * m[:, None]
        dp = -jnp.einsum("pij,pj->pi", V, gp + bt_x(dc), precision=_HI)
        dp = dp * point_valid[:, None]

        dR, dt = se3_exp(dc * free_c)
        R2, t2 = jax.vmap(se3_compose)(dR, dt, R, t)
        points2 = points + dp
        w0 = huber_weight(c, CHI2_STEREO) if use_huber else 1.0
        err0 = jax.lax.psum(jnp.sum(jnp.where(o_valid, c * w0, 0.0)), axis_name)
        err1, _ = total_chi2(R2, t2, points2, o_valid, use_huber)
        accept = err1 < err0
        R = jnp.where(accept, R2, R)
        t = jnp.where(accept, t2, t)
        points = jnp.where(accept, points2, points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        return (R, t, points, lam), None

    import functools as ft

    def run_stage(R, t, points, o_valid, n_iters, use_huber):
        body = ft.partial(lm_iteration, o_valid=o_valid, use_huber=use_huber)
        (R, t, points, _), _ = jax.lax.scan(
            body, (R, t, points, jnp.float32(1e-4)), None, length=n_iters
        )
        return R, t, points

    R, t, points = run_stage(R, t, points, obs_valid, iters1, True)
    _, c = total_chi2(R, t, points, obs_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    R, t, points = run_stage(R, t, points, o_valid, iters2, False)
    err, c = total_chi2(R, t, points, o_valid, False)
    o_valid = obs_valid & (c <= chi2_th)
    return R, t, points, o_valid, err


def make_distributed_ba_cg(mesh: Mesh, cam, scale_factor=1.2, iters1=5,
                           iters2=10, cg_iters=48, axis_name="dp"):
    """Jitted landmark-sharded CG-Schur bundle adjuster over `mesh`.

    Input layout as make_distributed_ba (points/observations sharded,
    obs_lm LOCAL per shard, cameras replicated).  Returns
    (R, t, points, obs_inlier, chi2)."""
    from jax import shard_map

    body = functools.partial(
        _cg_shard_body,
        cam=cam, scale_factor=scale_factor, iters1=iters1, iters2=iters2,
        cg_iters=cg_iters, axis_name=axis_name,
    )
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),
            P(axis_name), P(axis_name),
            P(axis_name), P(axis_name), P(axis_name), P(axis_name), P(axis_name),
        ),
        out_specs=(P(), P(), P(axis_name), P(axis_name), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_gba_pack(pack, n_shards: int):
    """Regroup a pack_local_ba(all_free=True) problem for the sharded
    adjusters: pad landmarks to a multiple of n_shards, route each
    observation to its landmark's shard, pad every shard's observation
    list to a common power-of-two bucket.  Returns (args, meta) where
    args feed make_distributed_ba_cg and meta maps results back."""
    import numpy as np

    P_tot = pack["points"].shape[0]
    p_per = -(-P_tot // n_shards)
    P_pad = p_per * n_shards
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:P_tot] = pack["points"]
    pval = np.zeros(P_pad, bool)
    pval[:P_tot] = pack["point_valid"]

    ov = pack["obs_valid"]
    shard_of = pack["obs_lm"] // p_per
    counts = np.bincount(shard_of[ov], minlength=n_shards)
    o_per = max(256, 1 << int(np.maximum(counts.max(), 1) - 1).bit_length())
    oc = np.zeros((n_shards, o_per), np.int32)
    ol = np.zeros((n_shards, o_per), np.int32)
    ouv = np.zeros((n_shards, o_per, 3), np.float32)
    ooct = np.zeros((n_shards, o_per), np.int32)
    oval = np.zeros((n_shards, o_per), bool)
    order = np.zeros((n_shards, o_per), np.int64)
    for d in range(n_shards):
        rows = np.nonzero(ov & (shard_of == d))[0][:o_per]
        n = len(rows)
        oc[d, :n] = pack["obs_cam"][rows]
        ol[d, :n] = pack["obs_lm"][rows] - d * p_per
        ouv[d, :n] = pack["obs_uvur"][rows]
        ooct[d, :n] = pack["obs_oct"][rows]
        oval[d, :n] = True
        order[d, :n] = rows
    args = (
        jnp.asarray(pack["R"]), jnp.asarray(pack["t"]),
        jnp.asarray(pack["cam_fixed"]),
        jnp.asarray(pts), jnp.asarray(pval),
        jnp.asarray(oc.reshape(-1)), jnp.asarray(ol.reshape(-1)),
        jnp.asarray(ouv.reshape(-1, 3)), jnp.asarray(ooct.reshape(-1)),
        jnp.asarray(oval.reshape(-1)),
    )
    meta = {"P_tot": P_tot, "order": order, "oval": oval, "o_per": o_per}
    return args, meta


def make_distributed_ba(mesh: Mesh, cam, scale_factor=1.2, n_iters=10,
                        axis_name="dp"):
    """Build a jitted landmark-sharded BA step over `mesh`.

    Expects inputs already laid out so that observation slice d refers
    only to landmark slice d (host groups observations by shard;
    obs_lm is LOCAL to each shard).  Shapes: points [P, 3] with P
    divisible by mesh size; obs arrays [O] with O divisible likewise.
    """
    from jax import shard_map

    body = functools.partial(
        _ba_shard_body,
        cam=cam, scale_factor=scale_factor, n_iters=n_iters,
        axis_name=axis_name,
    )
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),              # R, t, cam_fixed (replicated)
            P(axis_name), P(axis_name),  # points, point_valid
            P(axis_name), P(axis_name), P(axis_name), P(axis_name), P(axis_name),
        ),
        out_specs=(P(), P(), P(axis_name)),
        check_vma=False,
    )
    return jax.jit(sharded)
