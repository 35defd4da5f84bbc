"""Two-view triangulation of new map points between keyframes.

Rebuilds LocalMapping::CreateNewMapPoints +
ORBmatcher::SearchForTriangulation (SURVEY.md §2.1 rows 3, 11; §3.3):
for a keyframe pair, match unassociated features under the epipolar
constraint (dense masked Hamming matrix instead of the BoW node
pruning), triangulate linearly, and apply the reference's acceptance
checks (parallax, positive depth, reprojection error, scale
consistency).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST  # pixel-scale geometry: bf16-unsafe

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import hat, se3_apply, se3_compose, se3_inverse
from ..ops.hamming import hamming_matrix, knn2
from ..frontend.initializer import triangulate_two_view


def fundamental_from_poses(R1, t1, R2, t2, K):
    """F12 such that x2^T F x1 = 0 for pixel coords."""
    R12, t12 = se3_compose(R2, t2, *se3_inverse(R1, t1))  # cam2 <- cam1
    E = jnp.matmul(hat(t12), R12, precision=_HI)
    Kinv = jnp.linalg.inv(K)
    return jnp.matmul(jnp.matmul(Kinv.T, E, precision=_HI), Kinv, precision=_HI)


@functools.partial(jax.jit, static_argnames=("cam", "scale_factor"))
def triangulate_between(
    xy1, desc1, oct1, avail1,     # KF1 feature slots ([N,2],[N,32],[N],[N])
    xy2, desc2, oct2, avail2,     # KF2
    R1, t1, R2, t2,
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
):
    """Returns (idx2 [N] match in KF2 per KF1 feature, pts_w [N, 3],
    good [N]) for newly triangulated landmarks."""
    K = cam.K
    F12 = fundamental_from_poses(R1, t1, R2, t2, K)

    # Epipolar gate: distance of kp2 to the epipolar line of kp1.
    ah = jnp.concatenate([xy1, jnp.ones((xy1.shape[0], 1))], axis=1)
    lines2 = jnp.matmul(ah, F12.T, precision=_HI)  # line in image 2 per kp1
    bh = jnp.concatenate([xy2, jnp.ones((xy2.shape[0], 1))], axis=1)
    num = jnp.matmul(lines2, bh.T, precision=_HI) ** 2  # [N1, N2]
    den = lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2 + 1e-12
    d2 = num / den
    sigma2_2 = jnp.power(jnp.float32(scale_factor), 2.0 * oct2.astype(jnp.float32))
    epi_ok = d2 < 3.84 * sigma2_2[None, :]

    dist = hamming_matrix(desc1, desc2)
    gate = epi_ok & avail2[None, :]
    idx, d1, d2nd = knn2(dist, gate)
    matched = avail1 & (d1 < 50)

    p2 = xy2[idx]
    pts_c1 = triangulate_two_view(
        *se3_compose(R2, t2, *se3_inverse(R1, t1)), K, xy1, p2
    )
    # world coords
    Rwc1, twc1 = se3_inverse(R1, t1)
    pts_w = se3_apply(Rwc1, twc1, pts_c1)

    # checks: positive depth in both, reprojection, parallax
    pc1 = pts_c1
    pc2 = se3_apply(*se3_compose(R2, t2, *se3_inverse(R1, t1)), pts_c1)
    z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)

    def reproj_err(pc, obs):
        pr = jnp.matmul(pc, K.T, precision=_HI)
        w = jnp.where(jnp.abs(pr[:, 2:]) < 1e-9, 1e-9, pr[:, 2:])
        return jnp.sum((pr[:, :2] / w - obs) ** 2, axis=1)

    sigma2_1 = jnp.power(jnp.float32(scale_factor), 2.0 * oct1.astype(jnp.float32))
    r_ok = (reproj_err(pc1, xy1) < 5.991 * sigma2_1) & (
        reproj_err(pc2, p2) < 5.991 * sigma2_2[idx]
    )
    # parallax: rays must subtend a minimum angle
    Rrel, trel = se3_compose(R2, t2, *se3_inverse(R1, t1))
    c2_in_1 = -jnp.einsum("ji,j->i", Rrel, trel, precision=_HI)
    r1 = pc1
    r2 = pc1 - c2_in_1
    cosp = jnp.sum(r1 * r2, axis=1) / (
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1) + 1e-12
    )
    par_ok = cosp < 0.99995

    good = matched & z_ok & r_ok & par_ok
    return idx, pts_w, good


@functools.partial(jax.jit, static_argnames=("cam", "scale_factor"))
def triangulate_batch_flat(
    flat, own_frame, nb_frames, cam: CameraIntrinsics,
    scale_factor: float = 1.2,
):
    """triangulate_batch with masks/poses packed into ONE uint32 upload
    (feature tables come from the cached device frames)."""
    Nn = nb_frames.xy.shape[0]
    F = own_frame.xy.shape[0]
    off = [0]

    def take(n):
        v = jax.lax.dynamic_slice(flat, (off[0],), (n,))
        off[0] += n
        return v

    f32 = lambda v, *s: jax.lax.bitcast_convert_type(  # noqa: E731
        v, jnp.float32).reshape(*s)
    avail1 = take(F) > 0
    R1 = f32(take(9), 3, 3)
    t1 = f32(take(3), 3)
    avail2 = (take(Nn * F) > 0).reshape(Nn, F)
    R2 = f32(take(Nn * 9), Nn, 3, 3)
    t2 = f32(take(Nn * 3), Nn, 3)
    pv = take(Nn) > 0
    return triangulate_batch.__wrapped__(
        own_frame.xy, own_frame.desc, own_frame.octave, avail1, R1, t1,
        nb_frames.xy, nb_frames.desc, nb_frames.octave, avail2, R2, t2, pv,
        cam, scale_factor,
    )


@functools.partial(jax.jit, static_argnames=("cam", "scale_factor"))
def triangulate_batch(
    xy1, desc1, oct1, avail1, R1, t1,
    xy2s, desc2s, oct2s, avail2s, R2s, t2s, pair_valid,
    cam: CameraIntrinsics, scale_factor: float = 1.2,
):
    """All neighbor pairs in ONE device program (one dispatch + one
    fetch instead of 2 round-trips per neighbor)."""

    def one(xy2, desc2, oct2, avail2, R2, t2):
        return triangulate_between.__wrapped__(
            xy1, desc1, oct1, avail1, xy2, desc2, oct2, avail2,
            R1, t1, R2, t2, cam, scale_factor,
        )

    idx, pts, good = jax.vmap(one)(xy2s, desc2s, oct2s, avail2s, R2s, t2s)
    good = good & pair_valid[:, None]
    # one packed fetch: [Nn, N, 5] = idx, good, pts
    packed = jnp.concatenate(
        [
            idx.astype(jnp.float32)[..., None],
            good.astype(jnp.float32)[..., None],
            pts,
        ],
        axis=-1,
    )
    return packed


def dispatch_triangulation(store, kf_id, neighbor_ids, cam, scale_factor=1.2,
                           kf_frames=None, n_pairs=3):
    """Dispatch the batched triangulation program (no fetch). Returns a
    job consumed by apply_triangulation, or None.  Keyframe feature
    tables reuse cached per-KF device frames when available — the only
    per-event uploads are the availability masks and poses."""
    import jax.tree_util as jtu

    from .fuse import _kf_view_dev

    neighbor_ids = [int(k) for k in neighbor_ids][:n_pairs]
    avail1 = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] < 0)
    c1 = -store.kf_R[kf_id].T @ store.kf_t[kf_id]
    pairs = []
    for k2 in neighbor_ids:
        b = np.linalg.norm(c1 - (-store.kf_R[k2].T @ store.kf_t[k2]))
        if b >= 0.05:
            pairs.append(k2)
    if not pairs or not avail1.any():
        return None
    F = store.F
    Nn = n_pairs
    frames = [_kf_view_dev(store, k2, kf_frames) for k2 in pairs]
    while len(frames) < Nn:
        frames.append(frames[-1])
    nb = jtu.tree_map(lambda *xs: jnp.stack(xs), *frames)
    avail2 = np.zeros((Nn, F), bool)
    R2 = np.tile(np.eye(3, dtype=np.float32), (Nn, 1, 1))
    t2 = np.zeros((Nn, 3), np.float32)
    pv = np.zeros(Nn, bool)
    for i, k2 in enumerate(pairs):
        avail2[i] = store.kf_feat_valid[k2] & (store.kf_obs_lm[k2] < 0)
        R2[i] = store.kf_R[k2]
        t2[i] = store.kf_t[k2]
        pv[i] = True
    own = _kf_view_dev(store, kf_id, kf_frames)
    u = lambda a: np.ascontiguousarray(  # noqa: E731
        np.asarray(a, np.float32)).view(np.uint32).ravel()
    flat = np.concatenate([
        avail1.astype(np.uint32),
        u(store.kf_R[kf_id]), u(store.kf_t[kf_id]),
        avail2.astype(np.uint32).ravel(),
        u(R2), u(t2), pv.astype(np.uint32),
    ])
    packed = triangulate_batch_flat(
        jnp.asarray(flat), own, nb, cam, scale_factor,
    )
    try:
        # Land the result on host in the background: the apply-time
        # np.asarray then costs ~0 instead of a blocking round-trip.
        packed.copy_to_host_async()
    except AttributeError:
        pass
    return {
        "kf": kf_id, "pairs": pairs, "packed": packed,
        "kf_gen": int(store.kf_gen[kf_id]),
        "pair_gens": [int(store.kf_gen[k2]) for k2 in pairs],
    }


def apply_triangulation(store, job, max_new=256):
    """Fetch + apply a dispatched triangulation job (sequential dedup
    across pairs, first pair wins a feature row)."""
    if job is None:
        return np.asarray([], np.int32)
    kf_id = job["kf"]
    if not store.kf_valid[kf_id] or store.kf_gen[kf_id] != job["kf_gen"]:
        return np.asarray([], np.int32)  # culled + recycled since dispatch
    buf = np.asarray(job["packed"])  # [Nn, N, 5]
    created = []
    avail1 = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] < 0)
    for i, k2 in enumerate(job["pairs"]):
        if not store.kf_valid[k2] or store.kf_gen[k2] != job["pair_gens"][i]:
            continue
        idx = buf[i, :, 0].astype(np.int32)
        good = (buf[i, :, 1] > 0.5) & avail1
        pts_w = buf[i, :, 2:5]
        # neighbor feature must still be free at apply time
        good &= store.kf_obs_lm[k2, np.clip(idx, 0, store.F - 1)] < 0
        rows = np.nonzero(good)[0][:max_new]
        if len(rows) == 0:
            continue
        new_ids = store.add_points(
            pts_w[rows], store.kf_desc[kf_id][rows],
            store.kf_oct[kf_id][rows], kf_id, rows,
        )
        n_created = len(new_ids)
        store.kf_obs_lm[k2, idx[rows[:n_created]]] = new_ids
        store.touch_obs()
        avail1[rows[:n_created]] = False
        created.extend(int(i) for i in new_ids)
    return np.asarray(created, np.int32)


def create_new_map_points(store, kf_id, cam, scale_factor=1.2, n_neighbors=5,
                          max_new=256):
    """Synchronous CreateNewMapPoints (dispatch + immediate apply)."""
    ids, _ = store.covisible_keyframes(kf_id, min_weight=10, max_n=n_neighbors)
    job = dispatch_triangulation(store, kf_id, ids, cam, scale_factor)
    return apply_triangulation(store, job, max_new=max_new)
