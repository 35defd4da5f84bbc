"""Hessian-block assembly as one-hot matmuls + small batched inverses.

The BA solvers reduce per-observation blocks into per-camera /
per-landmark Hessian blocks, here as one-hot matmuls rather than
``zeros().at[idx].add(...)`` scatters.  Whether a scatter-add is faster
on the GPU is not measured yet (ROADMAP D9).  ``jnp.linalg.inv`` on a
[P, 3, 3] batch lowers to batched LU; the closed-form cofactor inverse
is exact to f32 rounding for the well-conditioned damped SPD blocks BA
produces.

Replaces the sparse-block machinery of g2o's BlockSolver
(Thirdparty/g2o/g2o/core/block_solver.h — SURVEY.md §2.2): the
reference's CCS block matrices become one-hot matmuls over static
shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Exact segment sums need full f32 products (TF32 would round the
# summed blocks to ~1e-3).
_HI = jax.lax.Precision.HIGHEST



def onehot_f32(idx: jnp.ndarray, n_rows: int) -> jnp.ndarray:
    """[n_rows, O] one-hot selection matrix (f32 so the matmul is
    exact: products are 0*x or 1*x)."""
    return (idx[None, :] == jnp.arange(n_rows)[:, None]).astype(jnp.float32)


def assemble(oh: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Segment-sum vals [O, ...] into [n_rows, ...] via one matmul."""
    flat = vals.reshape(vals.shape[0], -1)
    out = jax.lax.dot(oh, flat, precision=_HI, preferred_element_type=jnp.float32)
    return out.reshape(oh.shape[0], *vals.shape[1:])


def assemble_coupling(
    oh_lm: jnp.ndarray, oh_cam: jnp.ndarray, blocks: jnp.ndarray
) -> jnp.ndarray:
    """Coupling blocks B[p, c] = sum over observations with (lm=p,
    cam=c) of blocks [O, 6, k].  Each block lands in its camera's
    column strip (einsum with the camera one-hot), then one [P, O] @
    [O, C*6k] matmul reduces over observations."""
    O = blocks.shape[0]
    k = blocks.shape[1] * blocks.shape[2]
    C = oh_cam.shape[0]
    placed = jnp.einsum("co,oj->ocj", oh_cam, blocks.reshape(O, k), precision=_HI)
    out = jax.lax.dot(
        oh_lm, placed.reshape(O, C * k), precision=_HI,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(oh_lm.shape[0], C, blocks.shape[1], blocks.shape[2])


def chol33(V: jnp.ndarray) -> jnp.ndarray:
    """Closed-form lower Cholesky of a [..., 3, 3] SPD batch."""
    a = jnp.sqrt(jnp.maximum(V[..., 0, 0], 1e-30))
    b = V[..., 1, 0] / a
    c = V[..., 2, 0] / a
    d = jnp.sqrt(jnp.maximum(V[..., 1, 1] - b * b, 1e-30))
    e = (V[..., 2, 1] - c * b) / d
    f = jnp.sqrt(jnp.maximum(V[..., 2, 2] - c * c - e * e, 1e-30))
    z = jnp.zeros_like(a)
    return jnp.stack(
        [a, z, z, b, d, z, c, e, f], axis=-1
    ).reshape(*V.shape[:-2], 3, 3)


def chol44(V: jnp.ndarray) -> jnp.ndarray:
    """Closed-form lower Cholesky of a [..., 4, 4] SPD batch."""
    a = jnp.sqrt(jnp.maximum(V[..., 0, 0], 1e-30))
    r10 = V[..., 1, 0] / a
    r20 = V[..., 2, 0] / a
    r30 = V[..., 3, 0] / a
    b = jnp.sqrt(jnp.maximum(V[..., 1, 1] - r10 * r10, 1e-30))
    r21 = (V[..., 2, 1] - r20 * r10) / b
    r31 = (V[..., 3, 1] - r30 * r10) / b
    c = jnp.sqrt(jnp.maximum(V[..., 2, 2] - r20 * r20 - r21 * r21, 1e-30))
    r32 = (V[..., 3, 2] - r30 * r20 - r31 * r21) / c
    d = jnp.sqrt(
        jnp.maximum(V[..., 3, 3] - r30 * r30 - r31 * r31 - r32 * r32, 1e-30)
    )
    z = jnp.zeros_like(a)
    return jnp.stack(
        [a, z, z, z, r10, b, z, z, r20, r21, c, z, r30, r31, r32, d],
        axis=-1,
    ).reshape(*V.shape[:-2], 4, 4)


def inv33(H: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse of a [..., 3, 3] batch."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    out = jnp.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        axis=-1,
    ).reshape(*H.shape[:-2], 3, 3)
    return out * inv_det[..., None, None]


def inv44(H: jnp.ndarray) -> jnp.ndarray:
    """Blockwise 2x2 (Schur) inverse of a [..., 4, 4] batch; assumes the
    leading 2x2 block is invertible (true for the damped SPD blocks BA
    produces)."""
    A = H[..., :2, :2]
    B = H[..., :2, 2:]
    C = H[..., 2:, :2]
    D = H[..., 2:, 2:]

    def inv22(M):
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
        return (
            jnp.stack([d, -b, -c, a], axis=-1).reshape(*M.shape[:-2], 2, 2)
            * inv_det[..., None, None]
        )

    def mm(a, b):
        return jnp.matmul(a, b, precision=_HI)

    Ai = inv22(A)
    S = D - mm(mm(C, Ai), B)
    Si = inv22(S)
    AiB = mm(Ai, B)
    CAi = mm(C, Ai)
    top_left = Ai + mm(mm(AiB, Si), CAi)
    top_right = -mm(AiB, Si)
    bot_left = -mm(Si, CAi)
    return jnp.concatenate(
        [
            jnp.concatenate([top_left, top_right], axis=-1),
            jnp.concatenate([bot_left, Si], axis=-1),
        ],
        axis=-2,
    )
