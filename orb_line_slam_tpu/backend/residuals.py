"""Reprojection residuals for points (mono/stereo) and 3D line segments.

Static-shape JAX formulation of the g2o edge types the reference builds in
src/Optimizer.cc (SURVEY.md §2.1 row 13):
  - EdgeSE3ProjectXYZ(OnlyPose):      2-DoF mono point reprojection
  - EdgeStereoSE3ProjectXYZ(OnlyPose): 3-DoF stereo (u, v, uR)
  - line edges: 2-DoF perpendicular distance of the two projected 3D
    endpoint to the detected 2D infinite line (arXiv:1711.08654 §III-C).

Everything is batched; Jacobians come from jax.jacfwd of the residual
with respect to a zero SE3 tangent (exactly the analytic chain rule,
compiled by XLA).

Per-octave information: invSigma2 = 1 / scale^(2*octave) as in the
reference's mvInvLevelSigma2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics, project_stereo
from ..geometry.se3 import se3_apply, se3_exp, se3_compose


def inv_level_sigma2(octave: jnp.ndarray, scale_factor: float) -> jnp.ndarray:
    return jnp.power(jnp.float32(scale_factor), -2.0 * octave.astype(jnp.float32))


def make_point_residual_fn(cam: CameraIntrinsics):
    """Unified point residual [.., 3]: (du, dv, duR); duR is zeroed for
    mono observations via the is_stereo flag."""
    def fn(Rcw, tcw, xyz_w, obs_uvur, is_stereo):
        xc = se3_apply(Rcw, tcw, xyz_w)
        pred = project_stereo(cam, xc)
        r = pred - obs_uvur
        r = r.at[..., 2].set(jnp.where(is_stereo, r[..., 2], 0.0))
        return r

    return fn


def make_line_residual_fn(cam: CameraIntrinsics):
    """Line residual: project the 3D segment's endpoints, measure their
    signed perpendicular distances to the observed 2D infinite line.

    obs_line: [.., 3] normalized 2D line coefficients (a, b, c) with
    a^2+b^2 = 1, from the detected segment's endpoints.
    """

    def fn(Rcw, tcw, p_start_w, p_end_w, obs_line):
        ps = se3_apply(Rcw, tcw, p_start_w)
        pe = se3_apply(Rcw, tcw, p_end_w)

        def px(xc):
            z = jnp.where(jnp.abs(xc[..., 2]) < 1e-9, 1e-9, xc[..., 2])
            u = cam.fx * xc[..., 0] / z + cam.cx
            v = cam.fy * xc[..., 1] / z + cam.cy
            return u, v

        us, vs = px(ps)
        ue, ve = px(pe)
        d1 = obs_line[..., 0] * us + obs_line[..., 1] * vs + obs_line[..., 2]
        d2 = obs_line[..., 0] * ue + obs_line[..., 1] * ve + obs_line[..., 2]
        return jnp.stack([d1, d2], axis=-1)

    return fn


def line_obs_coeffs(p1_uv: jnp.ndarray, p2_uv: jnp.ndarray) -> jnp.ndarray:
    """Normalized infinite-line coefficients (a,b,c) through two 2D
    endpoints: the observation of a line feature."""
    a = p1_uv[..., 1] - p2_uv[..., 1]
    b = p2_uv[..., 0] - p1_uv[..., 0]
    c = p1_uv[..., 0] * p2_uv[..., 1] - p2_uv[..., 0] * p1_uv[..., 1]
    n = jnp.sqrt(a * a + b * b + 1e-12)
    return jnp.stack([a / n, b / n, c / n], axis=-1)


def pose_jacobian(residual_fn, Rcw, tcw, *args):
    """d residual / d (SE3 tangent at current pose), evaluated at 0.

    residual_fn(R, t, *args) -> [..., D].  Returns ([..., D], then the
    Jacobian [..., D, 6]) via forward-mode autodiff through the
    left-multiplicative retraction (matches g2o's update convention).
    """

    def f(xi):
        dR, dt = se3_exp(xi)
        R2, t2 = se3_compose(dR, dt, Rcw, tcw)
        return residual_fn(R2, t2, *args)

    zero = jnp.zeros(6, dtype=tcw.dtype)
    r = residual_fn(Rcw, tcw, *args)
    J = jax.jacfwd(f)(zero)
    return r, J
