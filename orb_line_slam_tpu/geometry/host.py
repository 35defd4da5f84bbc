"""Numpy twins of the SE3/Sim3 helpers for HOST bookkeeping.

The tracker/loop-closer host code manipulates single 3x3/3-vector poses
constantly (velocity model, relative-pose recording, correction
propagation).  Doing that with jax.numpy would dispatch dozens of eager
one-op XLA programs per frame — each a device round-trip.  These run on host numpy; device math stays
in the jitted programs (geometry/se3.py, geometry/sim3.py).
"""

from __future__ import annotations

import numpy as np


def nse3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): apply b first, then a."""
    R = Ra @ Rb
    return R.astype(np.float32), (Ra @ tb + ta).astype(np.float32)


def nse3_inverse(R, t):
    Rt = np.ascontiguousarray(R.T)
    return Rt.astype(np.float32), (-(Rt @ t)).astype(np.float32)


def nse3_apply(R, t, x):
    """Transform points x [..., 3]."""
    return (np.asarray(x) @ R.T + t).astype(np.float32)


def nse3_relative(Ra, ta, Rb, tb):
    """T_a ∘ T_b^-1 (a's camera from b's camera)."""
    R = Ra @ Rb.T
    return R.astype(np.float32), (ta - R @ tb).astype(np.float32)


def nsim3_compose(sa, Ra, ta, sb, Rb, tb):
    """x -> sa Ra (sb Rb x + tb) + ta."""
    return (
        float(sa * sb),
        (Ra @ Rb).astype(np.float32),
        (sa * (Ra @ tb) + ta).astype(np.float32),
    )


def nsim3_inverse(s, R, t):
    si = 1.0 / float(s)
    Rt = np.ascontiguousarray(R.T)
    return si, Rt.astype(np.float32), (-si * (Rt @ t)).astype(np.float32)


def nsim3_apply(s, R, t, x):
    return (float(s) * (np.asarray(x) @ R.T) + t).astype(np.float32)


def nquat_from_rotmat(R):
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order
    (numpy twin of geometry/se3.quat_from_rotmat, single pose)."""
    m = np.asarray(R, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    scores = [tr, m[0, 0], m[1, 1], m[2, 2]]
    best = int(np.argmax(scores))
    if best == 0:
        qw = np.sqrt(max(1.0 + tr, 1e-12)) * 0.5
        q = [(m[2, 1] - m[1, 2]) / (4 * qw), (m[0, 2] - m[2, 0]) / (4 * qw),
             (m[1, 0] - m[0, 1]) / (4 * qw), qw]
    elif best == 1:
        qx = np.sqrt(max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 1e-12)) * 0.5
        q = [qx, (m[0, 1] + m[1, 0]) / (4 * qx), (m[0, 2] + m[2, 0]) / (4 * qx),
             (m[2, 1] - m[1, 2]) / (4 * qx)]
    elif best == 2:
        qy = np.sqrt(max(1.0 - m[0, 0] + m[1, 1] - m[2, 2], 1e-12)) * 0.5
        q = [(m[0, 1] + m[1, 0]) / (4 * qy), qy, (m[1, 2] + m[2, 1]) / (4 * qy),
             (m[0, 2] - m[2, 0]) / (4 * qy)]
    else:
        qz = np.sqrt(max(1.0 - m[0, 0] - m[1, 1] + m[2, 2], 1e-12)) * 0.5
        q = [(m[0, 2] + m[2, 0]) / (4 * qz), (m[1, 2] + m[2, 1]) / (4 * qz),
             qz, (m[1, 0] - m[0, 1]) / (4 * qz)]
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def npluecker_from_endpoints(p1, p2):
    """Endpoints [...,3] -> Plücker (n, v); n = p1 x p2 (numpy twin of
    geometry/lines3d.pluecker_from_endpoints)."""
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    return np.cross(p1, p2), p2 - p1


def northonormal_from_pluecker(n, v):
    """(n, v) -> (U [...,3,3], w [...,2]) with (n|v) ~ U diag(w)."""
    nn = np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    nv = np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
    u1 = n / nn
    u2 = v / nv
    u3 = np.cross(u1, u2)
    U = np.stack([u1, u2, u3], axis=-1).astype(np.float32)
    w = np.concatenate([nn, nv], axis=-1)
    w = (w / (np.linalg.norm(w, axis=-1, keepdims=True) + 1e-12)).astype(np.float32)
    return U, w


def npluecker_from_orthonormal(U, w):
    n = w[..., 0:1] * U[..., :, 0]
    v = w[..., 1:2] * U[..., :, 1]
    return n.astype(np.float32), v.astype(np.float32)


def nclosest_points_on_line(n, v, pts):
    """Project points [...,3] onto the Plücker line (n, v)."""
    v2 = np.sum(v * v, axis=-1, keepdims=True) + 1e-12
    p0 = np.cross(v, n) / v2
    vhat = v / np.sqrt(v2)
    d = np.sum((np.asarray(pts) - p0) * vhat, axis=-1, keepdims=True)
    return (p0 + d * vhat).astype(np.float32)


def nbackproject(cam, xy, depth):
    """Pixel coords + depth -> camera-frame 3D points [..., 3]."""
    xy = np.asarray(xy, np.float32)
    z = np.asarray(depth, np.float32)
    x = (xy[..., 0] - cam.cx) / cam.fx * z
    y = (xy[..., 1] - cam.cy) / cam.fy * z
    return np.stack([x, y, z], axis=-1)
