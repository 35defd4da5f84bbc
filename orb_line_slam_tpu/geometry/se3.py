"""SO3/SE3 tangent-space operations (pure jax.numpy, batched-friendly).

Static-shape JAX replacement for the reference's g2o SE3Quat manifold
(reference: Thirdparty/g2o/g2o/types/se3quat.h, used throughout
src/Optimizer.cc — see SURVEY.md §2.2).  All functions are elementwise
over leading batch dims and safe under jit/vmap/grad.

Conventions:
  - Rotations are 3x3 matrices (row-major, world-to-camera for Tcw).
  - se3 tangent vectors are [rho(3), phi(3)] = [translation, rotation],
    matching g2o's SE3Quat::exp update order used by VertexSE3Expmap.
  - Poses are (R, t) pairs acting as x_cam = R @ x_world + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8
# Geometry matmuls are K=3 contractions: HIGHEST costs nothing, while
# a one-pass bf16 default injects ~0.4% into every pose transform
# (measured 3 cm mean error on 30 m points — the root cause of an
# earlier 13x device-vs-CPU drift gap, tools/exp_numerics.py); TF32 on
# the GPU would inject ~0.05%.
_HI = jax.lax.Precision.HIGHEST


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation matrix (3,3). Batched."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    # Taylor-safe coefficients.
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / theta2.clip(_EPS * _EPS)
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, a)
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * K2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle. Batched; safe near identity."""
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    scale = jnp.where(
        theta[..., None] < 1e-6,
        0.5 + theta[..., None] ** 2 / 12.0,
        theta[..., None] / (2.0 * sin_theta[..., None] + _EPS),
    )
    return scale * w


def _left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """SO3 left Jacobian J_l(phi), batched."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    b = (1.0 - jnp.cos(theta)) / theta2.clip(_EPS * _EPS)
    c = (theta - jnp.sin(theta)) / (theta2.clip(_EPS * _EPS) * theta)
    small = theta2 < 1e-12
    b = jnp.where(small, 0.5 - theta2 / 24.0, b)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b * K + c * K2


def se3_exp(xi: jnp.ndarray):
    """se3 tangent [rho, phi] (6,) -> (R (3,3), t (3,)). Batched."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = jnp.einsum("...ij,...j->...i", _left_jacobian(phi), rho, precision=_HI)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> tangent [rho, phi]. Batched."""
    phi = so3_log(R)
    Jl = _left_jacobian(phi)
    rho = jnp.linalg.solve(Jl, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b then a."""
    R = jnp.matmul(Ra, Rb, precision=_HI)
    t = jnp.einsum("...ij,...j->...i", Ra, tb, precision=_HI) + ta
    return R, t


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI)


def se3_apply(R, t, x):
    """Transform points x (...,3) by (R,t)."""
    return jnp.einsum("...ij,...j->...i", R, x, precision=_HI) + t


def se3_retract(R, t, xi):
    """Left-multiplicative update: exp(xi) * (R, t) — g2o VertexSE3Expmap
    ``oplusImpl`` semantics (update in the camera frame)."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


def quat_from_rotmat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.

    Branch-free Shepperd's method (batched); needed by the trajectory
    writers (reference: src/System.cc SaveTrajectoryTUM via
    Converter::toQuaternion, SURVEY.md §3.5).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best.
    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, _EPS, None)) * 0.5
    q0 = jnp.stack(
        [(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0), qw0],
        axis=-1,
    )
    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, _EPS, None)) * 0.5
    q1 = jnp.stack(
        [qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1), (m21 - m12) / (4 * qx1)],
        axis=-1,
    )
    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, _EPS, None)) * 0.5
    q2 = jnp.stack(
        [(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2), (m02 - m20) / (4 * qy2)],
        axis=-1,
    )
    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, _EPS, None)) * 0.5
    q3 = jnp.stack(
        [(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3, (m10 - m01) / (4 * qz3)],
        axis=-1,
    )
    cands = jnp.stack([q0, q1, q2, q3], axis=-2)
    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rotmat_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x,y,z,w) -> rotation matrix. Batched."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.clip(n, _EPS, None)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
