"""Cross-keyframe landmark fusion (SearchInNeighbors).

Rebuilds LocalMapping::SearchInNeighbors + ORBmatcher::Fuse
(SURVEY.md §2.1 rows 3, 11; §3.3): project the new keyframe's landmarks
into its covisible neighbours (and vice versa); where a projection hits
a feature already bound to a DIFFERENT landmark the two are duplicates
of one physical point — merge into the better-observed one; where it
hits a free feature, add the observation.  Kills the duplicate
landmarks that drift creates at revisits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..matching.point_matcher import resolve_duplicates, search_by_projection


def _kf_view(store, k):
    """Frame pytree over a keyframe's stored feature slots (jit-able)."""
    from ..frontend.frame import Frame

    return Frame(
        xy=jnp.asarray(store.kf_xy[k]),
        response=jnp.zeros(store.F, jnp.float32),
        angle=jnp.asarray(store.kf_angle[k]),
        octave=jnp.asarray(store.kf_oct[k]),
        desc=jnp.asarray(store.kf_desc[k]),
        valid=jnp.asarray(store.kf_feat_valid[k]),
        u_right=jnp.asarray(store.kf_ur[k]),
        depth=jnp.asarray(store.kf_depth[k]),
    )


def replace_point(store, src: int, dst: int):
    """Merge landmark src into dst (MapPoint::Replace)."""
    store.replace_points(np.asarray([src]), np.asarray([dst]))


def fuse_into_keyframe(store, lm_ids: np.ndarray, k: int, cam, level_scales,
                       radius: float = 3.0):
    """Project landmarks into keyframe k; add observations / merge
    duplicates. Returns number of fused observations."""
    lm_ids = lm_ids[store.pt_valid[lm_ids]]
    if len(lm_ids) == 0:
        return 0
    # Pad to a bucketed capacity: a raw len(lm_ids) shape would force an
    # XLA recompile of the projection-search program on every keyframe.
    n = len(lm_ids)
    cap = max(1024, 1 << (n - 1).bit_length())
    pad = cap - n
    ids_p = np.pad(lm_ids, (0, pad))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    view = _kf_view(store, k)
    m = search_by_projection(
        jnp.asarray(store.pt_pos[ids_p]),
        jnp.asarray(store.pt_desc[ids_p]),
        jnp.asarray(valid),
        jnp.asarray(store.pt_oct[ids_p]),
        jnp.asarray(store.kf_R[k]), jnp.asarray(store.kf_t[k]),
        view, cam, level_scales,
        radius=radius, max_dist=50, ratio=1.0, check_ur=True,
        max_dist_p=jnp.asarray(store.pt_max_dist[ids_p]),
        min_dist_p=jnp.asarray(store.pt_min_dist[ids_p]),
        normal_p=jnp.asarray(store.pt_normal[ids_p]),
        oct_tol=2,  # PredictScale is calibrated +1 for this detector
    )
    m = resolve_duplicates(m, store.F)
    import jax

    mask, idx = jax.device_get((m.mask, m.idx))
    counts = store.obs_counts()
    rows = np.nonzero(mask[:n])[0]
    if len(rows) == 0:
        return 0
    lm = lm_ids[rows].astype(np.int64)
    feat = idx[rows].astype(np.int64)
    existing = store.kf_obs_lm[k, feat].astype(np.int64)
    changed = existing != lm
    lm, feat, existing = lm[changed], feat[changed], existing[changed]
    if len(lm) == 0:
        return 0
    is_dup = (existing >= 0) & store.pt_valid[np.clip(existing, 0, None)]
    # Free slots: bind the landmark directly (new observation).
    free = ~is_dup
    if free.any():
        store.kf_obs_lm[k, feat[free]] = lm[free].astype(np.int32)
    # Duplicates: merge into the better-observed landmark (batched).
    if is_dup.any():
        a, b = lm[is_dup], existing[is_dup]
        keep_existing = counts[b] >= counts[a]
        src = np.where(keep_existing, a, b)
        dst = np.where(keep_existing, b, a)
        # Rebind the slot first so replace_points' remap settles it.
        store.kf_obs_lm[k, feat[is_dup]] = src.astype(np.int32)
        store.replace_points(src, dst)
    store.touch_obs()
    return int(len(lm))


def _apply_matches(store, k: int, lm_ids, mask, idx, lm_gens=None) -> int:
    """Apply projection-search matches into keyframe k: bind free slots,
    batch-merge duplicates into the better-observed landmark."""
    rows = np.nonzero(mask)[0]
    if len(rows) == 0:
        return 0
    counts = store.obs_counts()
    lm = lm_ids[rows].astype(np.int64)
    feat = idx[rows].astype(np.int64)
    live = store.pt_valid[lm] & store.kf_valid[k]
    if lm_gens is not None:
        # Landmark slots recycled since dispatch are different points.
        live &= store.pt_gen[lm] == lm_gens[rows]
    lm, feat = lm[live], feat[live]
    existing = store.kf_obs_lm[k, feat].astype(np.int64)
    changed = existing != lm
    lm, feat, existing = lm[changed], feat[changed], existing[changed]
    if len(lm) == 0:
        return 0
    is_dup = (existing >= 0) & store.pt_valid[np.clip(existing, 0, None)]
    free = ~is_dup
    if free.any():
        store.kf_obs_lm[k, feat[free]] = lm[free].astype(np.int32)
    if is_dup.any():
        a, b = lm[is_dup], existing[is_dup]
        keep_existing = counts[b] >= counts[a]
        src = np.where(keep_existing, a, b)
        dst = np.where(keep_existing, b, a)
        # Rebind the slot first so replace_points' remap settles it.
        store.kf_obs_lm[k, feat[is_dup]] = src.astype(np.int32)
        store.replace_points(src, dst)
    store.touch_obs()
    return int(len(lm))


FUSE_OWN_CAP = 2048
FUSE_POOL_CAP = 4096
FUSE_NN = 3


def _pad_ids(ids, cap):
    out = np.zeros(cap, np.int64)
    n = min(len(ids), cap)
    out[:n] = ids[:n]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return out, valid


@functools.partial(jax.jit, static_argnames=("cam", "level_scales"))
def _fuse_program_mirror(
    mir, flat, nb_frames, kf_frame, cam, level_scales,
):
    """Fuse with landmark tables GATHERED from the device-resident map
    mirror: the only upload is ids + poses (~25 KB).  The host-packed
    row tables (~440 KB) per keyframe — the mirror already holds pos/desc/oct/valid/
    maxd/mind/normal for every landmark slot."""
    Nn = nb_frames.xy.shape[0]
    OC, PC = FUSE_OWN_CAP, FUSE_POOL_CAP
    P = mir.pos.shape[0]
    off = [0]

    def take(n):
        v = jax.lax.dynamic_slice(flat, (off[0],), (n,))
        off[0] += n
        return v

    f32 = lambda v, *s: jax.lax.bitcast_convert_type(v, jnp.float32).reshape(*s)  # noqa: E731
    i32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)  # noqa: E731
    own_ids = i32(take(OC))
    pool_ids = i32(take(PC))
    nb_R = f32(take(Nn * 9), Nn, 3, 3)
    nb_t = f32(take(Nn * 3), Nn, 3)
    nb_valid = take(Nn) > 0
    kf_R = f32(take(9), 3, 3)
    kf_t = f32(take(3), 3)

    def gather(ids):
        r = jnp.clip(ids, 0, P - 1)
        valid = (ids >= 0) & mir.valid[r]
        return (mir.pos[r], mir.desc[r], mir.oct[r], valid,
                mir.maxd[r], mir.mind[r], mir.normal[r])

    own = gather(own_ids)
    pool = gather(pool_ids)
    return _fuse_program.__wrapped__(
        *own, *pool,
        nb_frames, nb_R, nb_t, nb_valid,
        kf_frame, kf_R, kf_t,
        cam, level_scales,
    )


@functools.partial(jax.jit, static_argnames=("cam", "level_scales"))
def _fuse_program_flat(
    flat, nb_frames, kf_frame, cam, level_scales,
):
    """Unpack the single uint32 input buffer (landmark tables in the
    mirror's 18-word row codec + poses), then run the fuse searches.
    One upload instead of ~19 — each small host->device transfer pays
    its own round-trip."""
    from ..pipeline.mirror import _rows_to_mirror_fields

    Nn = nb_frames.xy.shape[0]
    OC, PC = FUSE_OWN_CAP, FUSE_POOL_CAP
    off = [0]

    def take(n):
        v = jax.lax.dynamic_slice(flat, (off[0],), (n,))
        off[0] += n
        return v

    f32 = lambda v, *s: jax.lax.bitcast_convert_type(v, jnp.float32).reshape(*s)  # noqa: E731
    own_pos, own_desc, own_oct, own_valid, own_maxd, own_mind, own_normal = (
        _rows_to_mirror_fields(take(OC * 18).reshape(OC, 18))
    )
    pool_pos, pool_desc, pool_oct, pool_valid, pool_maxd, pool_mind, \
        pool_normal = _rows_to_mirror_fields(take(PC * 18).reshape(PC, 18))
    nb_R = f32(take(Nn * 9), Nn, 3, 3)
    nb_t = f32(take(Nn * 3), Nn, 3)
    nb_valid = take(Nn) > 0
    kf_R = f32(take(9), 3, 3)
    kf_t = f32(take(3), 3)
    return _fuse_program.__wrapped__(
        own_pos, own_desc, own_oct, own_valid, own_maxd, own_mind, own_normal,
        pool_pos, pool_desc, pool_oct, pool_valid, pool_maxd, pool_mind,
        pool_normal,
        nb_frames, nb_R, nb_t, nb_valid,
        kf_frame, kf_R, kf_t,
        cam, level_scales,
    )


@functools.partial(jax.jit, static_argnames=("cam", "level_scales"))
def _fuse_program(
    own_pos, own_desc, own_oct, own_valid, own_maxd, own_mind, own_normal,
    pool_pos, pool_desc, pool_oct, pool_valid, pool_maxd, pool_mind,
    pool_normal,
    nb_frames, nb_R, nb_t, nb_valid,
    kf_frame, kf_R, kf_t,
    cam, level_scales,
):
    """Forward (own landmarks → each neighbor) and reverse (pooled
    neighbor landmarks → the new keyframe) projection searches as ONE
    program; single packed int32 fetch."""

    def fwd(frame, R, t, pv):
        m = search_by_projection(
            own_pos, own_desc, own_valid & pv, own_oct, R, t, frame,
            cam, level_scales, radius=3.0, max_dist=50, ratio=1.0,
            check_ur=True, max_dist_p=own_maxd, min_dist_p=own_mind,
            normal_p=own_normal, oct_tol=2,
        )
        m = resolve_duplicates(m, own_pos.shape[0])
        return m.idx, m.mask

    fwd_idx, fwd_mask = jax.vmap(fwd, in_axes=(0, 0, 0, 0))(
        nb_frames, nb_R, nb_t, nb_valid
    )
    mr = search_by_projection(
        pool_pos, pool_desc, pool_valid, pool_oct, kf_R, kf_t, kf_frame,
        cam, level_scales, radius=3.0, max_dist=50, ratio=1.0,
        check_ur=True, max_dist_p=pool_maxd, min_dist_p=pool_mind,
        normal_p=pool_normal, oct_tol=2,
    )
    mr = resolve_duplicates(mr, pool_pos.shape[0])
    packed = jnp.concatenate([
        jnp.where(fwd_mask, fwd_idx, -1).reshape(-1),
        jnp.where(mr.mask, mr.idx, -1),
    ]).astype(jnp.int32)
    return packed


def _kf_view_dev(store, k, kf_frames):
    """Device Frame for keyframe k: the cached per-KF device frame when
    available (zero upload), else uploaded from the host store."""
    if kf_frames is not None and k in kf_frames:
        return kf_frames[k]
    return _kf_view(store, k)


def dispatch_fuse(store, kf: int, neighbor_ids, cam, level_scales,
                  kf_frames=None, mirror=None):
    """Dispatch the bidirectional fuse searches (no fetch). Returns a
    job for apply_fuse, or None."""
    import jax.tree_util as jtu

    neighbor_ids = [int(k) for k in neighbor_ids][:FUSE_NN]
    if not neighbor_ids:
        return None
    own = store.kf_obs_lm[kf]
    own = np.unique(own[own >= 0])
    own = own[store.pt_valid[own]]
    nb_obs = store.kf_obs_lm[neighbor_ids]
    pooled = np.unique(nb_obs[nb_obs >= 0])
    pooled = pooled[store.pt_valid[pooled]]
    if len(own) == 0 and len(pooled) == 0:
        return None
    own_p, own_v = _pad_ids(own, FUSE_OWN_CAP)
    pool_p, pool_v = _pad_ids(pooled, FUSE_POOL_CAP)

    frames = [_kf_view_dev(store, k2, kf_frames) for k2 in neighbor_ids]
    while len(frames) < FUSE_NN:
        frames.append(frames[-1])
    nb_frames = jtu.tree_map(lambda *xs: jnp.stack(xs), *frames)
    nb_R = np.tile(np.eye(3, dtype=np.float32), (FUSE_NN, 1, 1))
    nb_t = np.zeros((FUSE_NN, 3), np.float32)
    nb_valid = np.zeros(FUSE_NN, bool)
    for i, k2 in enumerate(neighbor_ids):
        nb_R[i] = store.kf_R[k2]
        nb_t[i] = store.kf_t[k2]
        nb_valid[i] = True

    u = lambda a: np.ascontiguousarray(  # noqa: E731
        np.asarray(a, np.float32)).view(np.uint32).ravel()
    if mirror is not None:
        # Ids + poses only; tables gathered from the device mirror.
        own_i = np.where(own_v, own_p, -1).astype(np.int32)
        pool_i = np.where(pool_v, pool_p, -1).astype(np.int32)
        flat = np.concatenate([
            own_i.view(np.uint32), pool_i.view(np.uint32),
            u(nb_R), u(nb_t), nb_valid.astype(np.uint32),
            u(store.kf_R[kf]), u(store.kf_t[kf]),
        ])
        packed = _fuse_program_mirror(
            mirror, jnp.asarray(flat), nb_frames,
            _kf_view_dev(store, kf, kf_frames),
            cam, tuple(level_scales),
        )
    else:
        # ONE packed upload (mirror row codec + poses); device unpack.
        from ..pipeline.mirror import pack_rows

        own_rows = pack_rows(store, own_p)
        own_rows[:, 0] &= own_v.astype(np.uint32)  # padding rows invalid
        pool_rows = pack_rows(store, pool_p)
        pool_rows[:, 0] &= pool_v.astype(np.uint32)
        flat = np.concatenate([
            own_rows.ravel(), pool_rows.ravel(),
            u(nb_R), u(nb_t), nb_valid.astype(np.uint32),
            u(store.kf_R[kf]), u(store.kf_t[kf]),
        ])
        packed = _fuse_program_flat(
            jnp.asarray(flat), nb_frames,
            _kf_view_dev(store, kf, kf_frames),
            cam, tuple(level_scales),
        )
    try:
        packed.copy_to_host_async()  # land on host while the host works
    except AttributeError:
        pass
    return {
        "kf": kf, "neighbors": neighbor_ids, "own": own_p, "n_own": len(own),
        "pool": pool_p, "n_pool": len(pooled), "packed": packed,
        "kf_gen": int(store.kf_gen[kf]),
        "nb_gens": [int(store.kf_gen[k2]) for k2 in neighbor_ids],
        "own_gens": store.pt_gen[own_p].copy(),
        "pool_gens": store.pt_gen[pool_p].copy(),
    }


def apply_fuse(store, job) -> int:
    """Fetch + apply a dispatched fuse job."""
    if job is None:
        return 0
    buf = np.asarray(job["packed"])
    Nn, OC, PC = FUSE_NN, FUSE_OWN_CAP, FUSE_POOL_CAP
    fwd = buf[: Nn * OC].reshape(Nn, OC)
    rev = buf[Nn * OC :]
    total = 0
    own = job["own"][: job["n_own"]]
    own_g = job["own_gens"][: job["n_own"]]
    for i, k2 in enumerate(job["neighbors"]):
        if not store.kf_valid[k2] or store.kf_gen[k2] != job["nb_gens"][i]:
            continue
        idx = fwd[i, : job["n_own"]]
        total += _apply_matches(store, k2, own, idx >= 0, idx, own_g)
    kf = job["kf"]
    if store.kf_valid[kf] and store.kf_gen[kf] == job["kf_gen"]:
        pool = job["pool"][: job["n_pool"]]
        idx = rev[: job["n_pool"]]
        total += _apply_matches(store, kf, pool, idx >= 0, idx,
                                job["pool_gens"][: job["n_pool"]])
        if total:
            own2 = store.kf_obs_lm[kf]
            store.update_point_stats(np.unique(own2[own2 >= 0]))
    return total


def search_in_neighbors(store, kf: int, cam, level_scales, n_neighbors: int = 5,
                        kf_frames=None):
    """Bidirectional fuse between a fresh keyframe and its covisible
    neighbours (synchronous dispatch + apply). Returns fused count."""
    ids, _ = store.covisible_keyframes(kf, min_weight=10, max_n=n_neighbors)
    job = dispatch_fuse(store, kf, ids, cam, level_scales, kf_frames=kf_frames)
    return apply_fuse(store, job)
