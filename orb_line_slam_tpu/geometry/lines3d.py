"""3D line geometry: Plücker coordinates + orthonormal 4-DoF updates.

The reference optimizes MapLines in BA with Plücker coordinates under
the orthonormal parameterization (arXiv:1711.08654 §III — SURVEY.md
§2.1 rows 8, 13).  A (scale-free) Plücker line is (n, v): n = moment
(p × d for any point p on the line), v = direction.  The orthonormal
representation factors it as
    (n|v) ~ U * diag(w1, w2),   U ∈ SO(3), (w1, w2) ∈ S^1,
giving exactly the 4 DoF of a 3D line: 3 for U (rotations) + 1 for the
scalar ratio w2/w1 (= 1/distance to origin).

All functions are batched jax.numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # pose geometry: full f32

from .se3 import hat, so3_exp


def pluecker_from_endpoints(p1: jnp.ndarray, p2: jnp.ndarray):
    """Endpoints (..., 3) -> Plücker (n (...,3), v (...,3)); n = p1 x p2."""
    n = jnp.cross(p1, p2)
    v = p2 - p1
    return n, v


def orthonormal_from_pluecker(n: jnp.ndarray, v: jnp.ndarray):
    """(n, v) -> (U (...,3,3), w (...,2)) with (n|v) ~ U diag(w)."""
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    nv = jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
    u1 = n / nn
    u2 = v / nv
    u3 = jnp.cross(u1, u2)
    U = jnp.stack([u1, u2, u3], axis=-1)  # columns
    w = jnp.concatenate([nn, nv], axis=-1)
    w = w / (jnp.linalg.norm(w, axis=-1, keepdims=True) + 1e-12)
    return U, w


def pluecker_from_orthonormal(U: jnp.ndarray, w: jnp.ndarray):
    """(U, w) -> (n, v) with the scale convention |(|n|,|v|)| = 1."""
    n = w[..., 0:1] * U[..., :, 0]
    v = w[..., 1:2] * U[..., :, 1]
    return n, v


def orthonormal_retract(U: jnp.ndarray, w: jnp.ndarray, xi: jnp.ndarray):
    """4-DoF update: U <- U exp([theta]x), w <- rot(phi) w.
    xi: (..., 4) = [theta (3), phi (1)]."""
    theta = xi[..., :3]
    phi = xi[..., 3]
    U2 = jnp.matmul(U, so3_exp(theta), precision=_HI)
    c = jnp.cos(phi)
    s = jnp.sin(phi)
    w1 = c * w[..., 0] - s * w[..., 1]
    w2 = s * w[..., 0] + c * w[..., 1]
    return U2, jnp.stack([w1, w2], axis=-1)


def pluecker_transform(Rcw: jnp.ndarray, tcw: jnp.ndarray,
                       n_w: jnp.ndarray, v_w: jnp.ndarray):
    """World->camera Plücker transform:
    n_c = R n_w + [t]x R v_w,  v_c = R v_w."""
    Rv = jnp.einsum("...ij,...j->...i", Rcw, v_w, precision=_HI)
    Rn = jnp.einsum("...ij,...j->...i", Rcw, n_w, precision=_HI)
    n_c = Rn + jnp.cross(tcw, Rv)
    return n_c, Rv


def line_projection_matrix(fx, fy, cx, cy):
    """K_L such that the image line of a camera-frame Plücker line is
    l = K_L @ n_c (homogeneous 2D line coefficients)."""
    return jnp.array(
        [
            [fy, 0.0, 0.0],
            [0.0, fx, 0.0],
            [-fy * cx, -fx * cy, fx * fy],
        ]
    )


def closest_points_on_line(n: jnp.ndarray, v: jnp.ndarray, pts: jnp.ndarray):
    """Project points (..., 3) onto the Plücker line (n, v): the closest
    point is p0 + ((p - p0)·v̂) v̂ with p0 = (v × n)/|v|^2."""
    v2 = jnp.sum(v * v, axis=-1, keepdims=True) + 1e-12
    p0 = jnp.cross(v, n) / v2
    vhat = v / jnp.sqrt(v2)
    d = jnp.sum((pts - p0) * vhat, axis=-1, keepdims=True)
    return p0 + d * vhat
