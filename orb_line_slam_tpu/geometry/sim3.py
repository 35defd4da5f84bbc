"""Sim3 similarity-transform manifold (scale + SE3), batched jax.numpy.

Static-shape JAX replacement for g2o's Sim3 type (reference:
Thirdparty/g2o/g2o/types/sim3.h, used by src/Optimizer.cc
OptimizeEssentialGraph / OptimizeSim3 and src/Sim3Solver.cc — SURVEY.md
§2.1 rows 13, 15).

A Sim3 is (s, R, t) acting as x' = s * R @ x + t.
Tangent vectors are [rho(3), phi(3), sigma(1)] (translation, rotation,
log-scale).
"""

from __future__ import annotations

import jax.numpy as jnp

from .se3 import _HI

from .se3 import hat, so3_exp, so3_log, _EPS


def sim3_identity(dtype=jnp.float32):
    return jnp.array(1.0, dtype), jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype)


def sim3_apply(s, R, t, x):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x, precision=_HI) + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) ∘ (sb,Rb,tb): apply b then a."""
    s = sa * sb
    R = jnp.matmul(Ra, Rb, precision=_HI)
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb, precision=_HI) + ta
    return s, R, t


def sim3_inverse(s, R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI)


def _sim3_W(phi, sigma):
    """The Sim3 'W' matrix coupling translation with rotation+scale.

    t = W @ rho for exp([rho, phi, sigma]).  Closed form per Strasdat's
    thesis (the same series g2o's Sim3::Sim3(update) implements).
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    K2 = jnp.matmul(K, K, precision=_HI)
    es = jnp.exp(sigma)

    sig = sigma
    small_sig = jnp.abs(sig) < 1e-5
    small_th = theta < 1e-5

    # A = coefficient of I, B of K, C of K^2
    # General case:
    a_gen = (es - 1.0) / jnp.where(small_sig, 1.0, sig)
    A = jnp.where(small_sig, 1.0 + sig / 2.0 + sig * sig / 6.0, a_gen)

    denom = sig * sig + theta2
    denom = jnp.where(denom < 1e-12, 1.0, denom)
    es_cos = es * jnp.cos(theta)
    es_sin = es * jnp.sin(theta)
    # B = (theta*(1 - es*cos) + sig*es*sin) / (theta*(sig^2+theta^2))
    b_gen = (
        (sig * es_sin + theta * (1.0 - es_cos))
        / (jnp.where(small_th, 1.0, theta) * denom)
    )
    b_small_th = jnp.zeros_like(b_gen) + (1.0 - A) * 0 + 0.5 * A * 0  # placeholder
    # For theta→0: B → (es*(sig-1)+1)/sig^2 ... use series: B ≈ 1/2 + sig/3
    b_series = 0.5 + sig / 3.0 + sig * sig / 8.0
    B = jnp.where(small_th, jnp.where(small_sig, 0.5 + sig / 3.0, b_series), b_gen)

    # C = (A - ((es*cos-1)*sig + es*sin*theta)/(sig^2+theta^2)) / theta^2
    c_num = A - ((es_cos - 1.0) * sig + es_sin * theta) / denom
    c_gen = c_num / jnp.where(small_th, 1.0, theta2)
    c_series = 1.0 / 6.0 + sig / 12.0
    C = jnp.where(small_th, c_series, c_gen)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return A[..., None, None] * eye + B[..., None, None] * K + C[..., None, None] * K2


def sim3_exp(xi):
    """Tangent [rho(3), phi(3), sigma(1)] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = jnp.exp(sigma)
    W = _sim3_W(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", W, rho, precision=_HI)
    return s, R, t


def sim3_log(s, R, t):
    """(s, R, t) -> tangent [rho, phi, sigma]."""
    phi = so3_log(R)
    sigma = jnp.log(s)
    W = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_retract(s, R, t, xi):
    """Left-multiplicative update exp(xi) ∘ (s,R,t) — g2o VertexSim3Expmap
    oplus semantics."""
    ds, dR, dt = sim3_exp(xi)
    return sim3_compose(ds, dR, dt, s, R, t)
