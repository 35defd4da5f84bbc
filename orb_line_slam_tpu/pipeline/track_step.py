"""The fused per-frame tracking device program.

Static-shape JAX rebuild of the Tracking::Track inner loop (src/Tracking.cc,
SURVEY.md §3.2 hot loops 4-5): ONE jitted XLA program per frame chains

  motion-model projection search → motion-only pose opt (path A)
  reference-KF descriptor match  → motion-only pose opt (path B)
  branchless path select (the reference's if-fail-fallback)
  local-map projection search at the selected pose
  (optional) map-line projection match
  final joint pose opt + inlier gating + keyframe-decision statistics

The reference runs these as ~6 separate steps with CPU bookkeeping in
between; splitting them the same way on a device costs one host
round-trip per step.  Fusing them means the host dispatches once and fetches ONE compact result
(~30 KB) per frame; all cross-stage dataflow stays on device.

Landmark state crosses the host boundary as a **device-resident map
mirror** (`MapMirror`): the point table lives on device and is
re-uploaded only when the host map mutates (keyframe creation, BA
write-back, loop correction — per-keyframe events, not per-frame).
Per-frame inputs are just the new Frame, the previous frame's
association vector (already on device as the previous step's output)
and a handful of pose scalars; every landmark table the step needs
(last-frame table, reference-KF table, local-map snapshot) is a gather
from the mirror by index.  This removes ~30 host→device transfers per
frame.

Branchless fallback: path B (reference-KF match) is computed every
frame instead of only when path A fails — the extra masked Hamming
matmul is cheaper than a second dispatch round-trip would be.  Landmark identity crosses the host boundary as GLOBAL ids
(gid arrays), so the host never has to re-map rows mid-frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
_HI = jax.lax.Precision.HIGHEST  # small-K geometry: bf16-unsafe

from ..backend.pnp import solve_pnp_ransac
from ..backend.pose_opt import pose_optimize
from ..backend.residuals import (
    inv_level_sigma2,
    line_obs_coeffs,
    make_point_residual_fn,
)
from ..config import SlamConfig
from ..geometry.camera import project_stereo
from ..geometry.se3 import se3_apply, se3_compose
from ..matching.line_matcher import search_lines_by_projection
from ..matching.point_matcher import (
    match_descriptors,
    resolve_duplicates,
    rotation_consistency,
    search_by_projection,
)


class MapMirror(NamedTuple):
    """Device-resident mirror of the MapStore point table (uploaded
    once per map mutation — see Tracker._refresh_mirror)."""

    pos: jnp.ndarray     # float32 [P, 3]
    desc: jnp.ndarray    # uint8 [P, 32]
    oct: jnp.ndarray     # int32 [P]
    valid: jnp.ndarray   # bool [P]
    maxd: jnp.ndarray    # float32 [P]
    mind: jnp.ndarray    # float32 [P]
    normal: jnp.ndarray  # float32 [P, 3]


class TrackOut(NamedTuple):
    """Per-frame device outputs.  In the steady-state pipelined loop the
    host fetches ONLY `packed` (one ~100 B transfer, overlapped with the
    next frame's compute); everything else is either a device carry fed
    straight into the next frame's dispatch (R, t, Rv, tv, ok,
    assoc_gid, found_acc, vis_acc) or fetched lazily at keyframe events
    (assoc_gid, ln_match_*, found_acc, vis_acc via pack_kf_event)."""

    R: jnp.ndarray              # float32 [3,3] final pose (carry)
    t: jnp.ndarray              # float32 [3]
    Rv: jnp.ndarray             # float32 [3,3] velocity T_k<-k-1 (carry)
    tv: jnp.ndarray             # float32 [3]
    ok: jnp.ndarray             # bool — tracking succeeded (carry: has_velocity)
    assoc_gid: jnp.ndarray      # int32 [N] global landmark id per feature (-1)
    inliers: jnp.ndarray        # bool [N] pose-opt-2 point inliers
    found_acc: jnp.ndarray      # int32 [cap] per-snapshot found counter (carry)
    vis_acc: jnp.ndarray        # int32 [cap] per-snapshot visible counter (carry)
    ln_found_acc: jnp.ndarray   # int32 [Lcap] per-mirror-line found (carry)
    ln_vis_acc: jnp.ndarray     # int32 [Lcap] per-mirror-line visible (carry)
    ln_match_idx: jnp.ndarray   # int32 [Lcap] map line -> frame line row
    ln_match_mask: jnp.ndarray  # bool [Lcap]
    packed: jnp.ndarray         # float32 [19] — the ONLY per-frame fetch:
    # [0:9]=R, [9:12]=t, 12=ok, 13=n_inliers, 14=used_motion,
    # 15=stage1_ok, 16=n_stage1, 17=tracked_close, 18=untracked_close


def _invert_matches(m_idx, m_mask, n_rows: int, n_feats: int):
    """Per-landmark-row matches -> per-frame-feature source row (-1)."""
    tgt = jnp.where(m_mask, m_idx, n_feats)
    out = jnp.full((n_feats + 1,), -1, jnp.int32)
    out = out.at[tgt].set(jnp.arange(n_rows, dtype=jnp.int32))
    return out[:n_feats]


@functools.partial(jax.jit, static_argnames=("cfg", "has_lines"))
def track_step(
    frame,                       # Frame pytree (current, device)
    last_frame,                  # Frame pytree (previous, device)
    mir: MapMirror,              # device map mirror (per-KF upload)
    last_gid,                    # int32 [N] prev frame's landmark ids (device)
    # Velocity prior T_k<-k-1 and last pose:
    Rv, tv, R_last, t_last, has_velocity,
    # Reference-KF feature slots (per-KF uploads, row-aligned tables):
    ref_xy, ref_desc, ref_angle, ref_slots,
    # Local-map snapshot landmark ids [cap] (-1 pad; per-KF upload):
    snap_ids,
    # Per-snapshot found/visible accumulators (device carries):
    found_acc, vis_acc,
    # Per-mirror-line found/visible accumulators (device carries):
    ln_found_acc, ln_vis_acc,
    # Lines (dummy [8]-arrays when has_lines=False):
    lf,                          # LineFeatures pytree or None
    ln_start, ln_end, ln_desc, ln_valid,
    cfg: SlamConfig,
    has_lines: bool = False,
) -> TrackOut:
    cam = cfg.camera
    scales = cfg.orb.level_scales
    N = frame.xy.shape[0]
    P = mir.pos.shape[0]
    cap = snap_ids.shape[0]

    # ---- Landmark tables: gathers from the device mirror --------------
    lr = jnp.clip(last_gid, 0, P - 1)
    last_sel = (last_gid >= 0) & mir.valid[lr]
    last_pos = mir.pos[lr]
    last_desc = mir.desc[lr]
    last_maxd = mir.maxd[lr]

    rr = jnp.clip(ref_slots, 0, P - 1)
    ref_has_lm = (ref_slots >= 0) & mir.valid[rr]
    ref_pos = mir.pos[rr]
    ref_gid = jnp.where(ref_has_lm, ref_slots, -1)

    sr = jnp.clip(snap_ids, 0, P - 1)
    snap_valid = (snap_ids >= 0) & mir.valid[sr]
    snap_pos = mir.pos[sr]
    snap_desc = mir.desc[sr]
    snap_oct = mir.oct[sr]
    snap_maxd = jnp.where(snap_valid, mir.maxd[sr], 1.0)
    snap_mind = jnp.where(snap_valid, mir.mind[sr], 0.0)
    snap_normal = mir.normal[sr]
    snap_gid = jnp.where(snap_valid, snap_ids, -1)

    F = ref_desc.shape[0]

    # ---- Path A: motion model ---------------------------------------
    Rp, tp = se3_compose(Rv, tv, R_last, t_last)
    mA = search_by_projection(
        last_pos, last_desc, last_sel & has_velocity, last_frame.octave,
        Rp, tp, frame, cam, scales,
        radius=cfg.tracking.motion_search_radius, ratio=0.9, check_ur=True,
        max_dist_p=last_maxd,
    )
    mA = resolve_duplicates(mA, N)
    keepA = rotation_consistency(last_frame.angle, frame.angle[mA.idx], mA.mask)
    n_mm = jnp.sum(keepA.astype(jnp.int32))
    rowA = _invert_matches(mA.idx, keepA, N, N)        # frame feat -> last row
    selA = rowA >= 0
    rA = jnp.where(selA, rowA, 0)
    ptsA = last_pos[rA]
    gidA = jnp.where(selA & last_sel[rA], last_gid[rA], -1)
    selA = gidA >= 0

    obs = jnp.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], -1)
    # Short stage-1 schedule: this pose only seeds the radius-4 local-map
    # search and the final joint optimization (full 4x10) below; 2x8
    # converges within the search tolerance at ~40% of the device time.
    resA = pose_optimize(
        Rp, tp, ptsA, obs, frame.octave, selA & frame.valid,
        cam, cfg.orb.scale_factor, rounds=2, iters=8,
    )
    okA = has_velocity & (n_mm >= 20) & (resA.n_inliers >= 10)

    # ---- Path B: reference keyframe (BoW-match analog) ---------------
    # B's INDEPENDENT solve runs every frame: path A anchors to the last
    # frame (drift random-walks), B anchors to the reference keyframe.
    # Skipping B's solve when A "looks healthy" was measured to let A's
    # bias self-confirm (its matches are selected BY the velocity
    # prediction) — inliers decay 300 -> 50 within 5 frames and the
    # keyframe rate triples.  Only the EPnP init is conditional.
    du = frame.xy[:, 0:1] - ref_xy[None, :, 0]
    dv = frame.xy[:, 1:2] - ref_xy[None, :, 1]
    window = (du * du + dv * dv) < 150.0**2
    mB = match_descriptors(
        frame.desc, frame.valid, ref_desc, ref_has_lm,
        max_dist=50, ratio=0.75, extra_mask=window,
    )
    keepB = rotation_consistency(frame.angle, ref_angle[mB.idx], mB.mask)
    n_ref = jnp.sum(keepB.astype(jnp.int32))
    selB = keepB
    rB = jnp.where(selB, mB.idx, 0)
    ptsB = ref_pos[rB]
    gidB = jnp.where(selB, ref_gid[rB], -1)

    # RANSAC-EPnP pose init (beyond the reference, which seeds LM at the
    # last pose): path B matches are descriptor-windowed, not
    # projection-gated, so a single wrong-depth landmark with ~fx/z
    # leverage can anchor a straight LM solve in a wrong basin (measured
    # 0.16 m pose bias from one ghost).  128 batched EPnP hypotheses
    # make the init outlier-proof — and INDEPENDENT of path A, which is
    # what lets B arrest A's drift (seeding B from A was measured to
    # collapse tracking within ~5 frames).
    sigma2B = (cfg.orb.scale_factor ** frame.octave.astype(jnp.float32)) ** 2
    Rr, tr, _, n_r = solve_pnp_ransac(
        ptsB, frame.xy, selB & frame.valid, jax.random.PRNGKey(17), cam,
        sigma2B,
    )
    use_r = n_r >= 10
    R_b0 = jnp.where(use_r, Rr, R_last)
    t_b0 = jnp.where(use_r, tr, t_last)
    resB = pose_optimize(
        R_b0, t_b0, ptsB, obs, frame.octave, selB & frame.valid,
        cam, cfg.orb.scale_factor, rounds=2, iters=8,
    )
    okB = (n_ref >= 15) & (resB.n_inliers >= 10)

    # ---- Stage-1 select (reference: fallback ladder, upgraded) --------
    # Pick the better-supported pose; feed the UNION of both association
    # sets into the final joint optimization (chi2 gating prunes
    # whichever half is wrong).
    scoreA = jnp.where(okA, resA.n_inliers, -1)
    scoreB = jnp.where(okB, resB.n_inliers, -1)
    use_mm = okA & (scoreA >= scoreB)
    stage1_ok = okA | okB
    R1 = jnp.where(use_mm, resA.R, resB.R)
    t1 = jnp.where(use_mm, resA.t, resB.t)
    n1 = jnp.where(use_mm, resA.n_inliers, resB.n_inliers)
    selA_in = selA & resA.inliers & okA
    selB_in = selB & resB.inliers & okB
    sel1 = selA_in | selB_in
    gid1 = jnp.where(selA_in, gidA, jnp.where(selB_in, gidB, -1))
    pts1 = jnp.where(selA_in[:, None], ptsA, ptsB)

    # ---- Local map search at the selected pose ------------------------
    # Exclude snapshot landmarks already associated in stage 1 (by gid).
    hit = (snap_gid[:, None] == gid1[None, :]) & (gid1 >= 0)[None, :]
    already = jnp.any(hit, axis=1)
    m5 = search_by_projection(
        snap_pos, snap_desc, snap_valid & ~already & stage1_ok, snap_oct,
        R1, t1, frame, cam, scales,
        radius=4.0, max_dist=50, ratio=0.8, check_ur=True,
        max_dist_p=snap_maxd, min_dist_p=snap_mind, normal_p=snap_normal,
    )
    m5 = resolve_duplicates(m5, N)
    row5 = _invert_matches(m5.idx, m5.mask, cap, N)
    sel5 = (row5 >= 0) & ~sel1
    r5 = jnp.where(sel5, row5, 0)
    gid_merged = jnp.where(sel1, gid1, jnp.where(sel5, snap_gid[r5], -1))
    pts_merged = jnp.where(sel1[:, None], pts1, snap_pos[r5])
    sel_merged = (sel1 | sel5) & frame.valid

    # Visibility stats (SearchLocalPoints' "visible" counter): frustum
    # test of the snapshot at the stage-1 pose.
    xc = se3_apply(R1, t1, snap_pos)
    uvr = project_stereo(cam, xc)
    cc = -jnp.einsum("ji,j->i", R1, t1, precision=_HI)
    view = snap_pos - cc
    vdist = jnp.linalg.norm(view, axis=-1)
    cosang = jnp.sum(view * snap_normal, axis=-1) / jnp.maximum(vdist, 1e-6)
    visible_snap = (
        snap_valid
        & (xc[:, 2] > 0.1)
        & (uvr[:, 0] >= 0) & (uvr[:, 0] < cam.width)
        & (uvr[:, 1] >= 0) & (uvr[:, 1] < cam.height)
        & (vdist >= 0.8 * snap_mind) & (vdist <= 1.2 * snap_maxd)
        & (cosang > 0.5)
    )

    # ---- Map lines ----------------------------------------------------
    Lcap = ln_start.shape[0]
    if has_lines:
        mL = search_lines_by_projection(
            ln_start, ln_end, ln_desc, ln_valid, R1, t1, lf, cam,
        )
        l_obs = line_obs_coeffs(lf.p0[mL.idx], lf.p1[mL.idx])
        line_kw = dict(
            line_start_w=ln_start, line_end_w=ln_end, line_obs=l_obs,
            line_octave=jnp.zeros(Lcap, jnp.int32),
            line_valid=mL.mask & ln_valid,
        )
        ln_match_idx = mL.idx
        ln_match_mask = mL.mask
    else:
        line_kw = {}
        ln_match_idx = jnp.full((Lcap,), -1, jnp.int32)
        ln_match_mask = jnp.zeros((Lcap,), bool)

    # ---- Final joint pose opt ------------------------------------------
    res2 = pose_optimize(
        R1, t1, pts_merged, obs, frame.octave, sel_merged,
        cam, cfg.orb.scale_factor, **line_kw,
    )
    gid_out = jnp.where(res2.inliers & sel_merged, gid_merged, -1)

    # ---- Keyframe-decision statistics ----------------------------------
    close = frame.valid & (frame.depth > 0) & (
        frame.depth < cfg.tracking.th_depth * cam.baseline
    )
    tracked_close = jnp.sum((close & (gid_out >= 0)).astype(jnp.int32))
    untracked_close = jnp.sum((close & (gid_out < 0)).astype(jnp.int32))

    # ---- Device carries for the next frame -----------------------------
    ok = stage1_ok & (res2.n_inliers >= 10)
    R_out = jnp.where(ok, res2.R, R_last)
    t_out = jnp.where(ok, res2.t, t_last)
    # velocity = T_k ∘ T_{k-1}^{-1}
    Ri, ti = R_last.T, -jnp.einsum("ji,j->i", R_last, t_last, precision=_HI)
    Rv_out, tv_out = se3_compose(R_out, t_out, Ri, ti)

    # found/visible accumulators (IncreaseFound / IncreaseVisible):
    # applied to the host map only at keyframe events.
    found_hit = jnp.any(
        (snap_gid[:, None] == gid_out[None, :]) & (gid_out >= 0)[None, :],
        axis=1,
    )
    found_acc2 = found_acc + found_hit.astype(jnp.int32)
    vis_acc2 = vis_acc + visible_snap.astype(jnp.int32)

    # Line landmark statistics (MapLine IncreaseFound/IncreaseVisible,
    # SURVEY.md §2.1 row 8): visible = both endpoints project in front
    # of the final pose into the image; found = matched this frame AND
    # survived the joint optimization's line chi2 gate.
    if has_lines:
        mid = 0.5 * (ln_start + ln_end)
        xm = se3_apply(res2.R, res2.t, mid)
        uvm = project_stereo(cam, xm)
        ln_visible = (
            ln_valid
            & (xm[:, 2] > 0.1)
            & (uvm[:, 0] >= 0) & (uvm[:, 0] < cam.width)
            & (uvm[:, 1] >= 0) & (uvm[:, 1] < cam.height)
        )
        ln_found = ln_match_mask & ln_valid & res2.line_inliers
        ln_found_acc2 = ln_found_acc + ln_found.astype(jnp.int32)
        ln_vis_acc2 = ln_vis_acc + ln_visible.astype(jnp.int32)
    else:
        ln_found_acc2 = ln_found_acc
        ln_vis_acc2 = ln_vis_acc

    f32 = lambda x: jnp.asarray(x, jnp.float32).reshape(-1)  # noqa: E731
    packed = jnp.concatenate([
        f32(R_out), f32(t_out), f32(ok), f32(res2.n_inliers), f32(use_mm),
        f32(stage1_ok), f32(n1), f32(tracked_close), f32(untracked_close),
    ])

    return TrackOut(
        R=R_out, t=t_out, Rv=Rv_out, tv=tv_out, ok=ok,
        assoc_gid=gid_out, inliers=res2.inliers,
        found_acc=found_acc2, vis_acc=vis_acc2,
        ln_found_acc=ln_found_acc2, ln_vis_acc=ln_vis_acc2,
        ln_match_idx=ln_match_idx, ln_match_mask=ln_match_mask,
        packed=packed,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "has_lines"))
def fused_frame_track_step(
    img_l, img_r,
    last_frame, mir: MapMirror, last_gid,
    Rv, tv, R_last, t_last, has_velocity,
    ref_xy, ref_desc, ref_angle, ref_slots,
    snap_ids, found_acc, vis_acc, ln_found_acc, ln_vis_acc,
    ln_start, ln_end, ln_desc, ln_valid,
    cfg: SlamConfig, has_lines: bool = False,
):
    """ONE device program per steady-state frame: stereo front-end +
    line front-end + the fused tracking step.  Dispatching them as
    three programs leaves inter-program scheduling gaps; a single
    dispatch lets XLA schedule the whole frame back to back.
    Returns (frame, line_features_or_None, TrackOut)."""
    from ..frontend.frame import build_stereo_frame
    from ..frontend.line_extractor import build_line_features

    frame = build_stereo_frame(img_l, img_r, cfg)
    lf = None
    if cfg.lines.enabled:
        lf = build_line_features(img_l, img_r, cfg.camera, cfg.lines)
    out = track_step(
        frame, last_frame, mir, last_gid,
        Rv, tv, R_last, t_last, has_velocity,
        ref_xy, ref_desc, ref_angle, ref_slots,
        snap_ids, found_acc, vis_acc, ln_found_acc, ln_vis_acc,
        lf if has_lines else None,
        ln_start, ln_end, ln_desc, ln_valid,
        cfg=cfg, has_lines=has_lines,
    )
    return frame, lf, out


@jax.jit
def remap_stats(out: TrackOut, remap, ln_remap) -> TrackOut:
    """Re-index the found/visible accumulator carries when the local-map
    snapshot changes between keyframe events (mid-interval mirror
    refreshes after async BA/fuse applies): new slot j takes old slot
    remap[j]'s count (-1 -> 0).  Without this, counts accumulated
    against the old snapshot would be credited to whatever landmark now
    occupies the slot (ADVICE r2 #1)."""
    def take(a, r):
        return jnp.where(r >= 0, a[jnp.clip(r, 0, None)], 0)

    return out._replace(
        found_acc=take(out.found_acc, remap),
        vis_acc=take(out.vis_acc, remap),
        ln_found_acc=take(out.ln_found_acc, ln_remap),
        ln_vis_acc=take(out.ln_vis_acc, ln_remap),
    )


@jax.jit
def zero_stats(out: TrackOut) -> TrackOut:
    """Reset the found/visible accumulators in a carry (dispatched at
    keyframe events after the host consumed them — no uploads)."""
    return out._replace(
        found_acc=jnp.zeros_like(out.found_acc),
        vis_acc=jnp.zeros_like(out.vis_acc),
        ln_found_acc=jnp.zeros_like(out.ln_found_acc),
        ln_vis_acc=jnp.zeros_like(out.ln_vis_acc),
    )


@jax.jit
def override_carry(out: TrackOut, R, t) -> TrackOut:
    """Rewrite the pose carry after a host-side pose correction (BA
    ride-along, loop closure). Velocity is frame-relative and survives
    rigid re-anchoring, so it is kept."""
    return out._replace(R=R, t=t)


@jax.jit
def pack_kf_event(frame, out: TrackOut, lines=None):
    """Flatten everything the host needs at a keyframe event into ONE
    float32 buffer (a single ~180 KB fetch instead of ~15 round-trips): the full feature table of the
    keyframe's frame, the association vector, line matches, the
    found/visible accumulators, and (when enabled) the frame's line
    features — a separate jax.device_get of the 8-leaf LineFeatures
    pytree would be 8 serial fetches per keyframe."""
    N = frame.xy.shape[0]
    f32 = lambda x: jnp.asarray(x, jnp.float32).reshape(-1)  # noqa: E731
    desc32 = jax.lax.bitcast_convert_type(
        frame.desc.reshape(N, 8, 4), jnp.float32
    )
    parts = [
        f32(frame.xy), f32(frame.u_right), f32(frame.depth),
        f32(frame.octave), f32(frame.angle), f32(frame.valid),
        f32(frame.response), f32(desc32),
        f32(out.assoc_gid), f32(out.inliers),
        f32(out.ln_match_idx), f32(out.ln_match_mask),
        f32(out.found_acc), f32(out.vis_acc),
        f32(out.ln_found_acc), f32(out.ln_vis_acc),
    ]
    if lines is not None:
        L = lines.p0.shape[0]
        ldesc32 = jax.lax.bitcast_convert_type(
            lines.desc.reshape(L, 8, 4), jnp.float32
        )
        parts += [
            f32(lines.p0), f32(lines.p1), f32(lines.angle),
            f32(lines.length), f32(ldesc32), f32(lines.valid),
            f32(lines.depth0), f32(lines.depth1),
        ]
    return jnp.concatenate(parts)
