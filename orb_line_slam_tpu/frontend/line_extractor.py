"""Line feature extraction + stereo endpoint depth.

Rebuilds the reference's LineExtractor wrapper + Frame's stereo line
endpoint association (src/LineExtractor.cc, src/Frame.cc line paths —
SURVEY.md §2.1 rows 5, 10): detect segments (ops/lines.py), describe
with LBD (ops/lbd.py), then recover 3D endpoints from the rectified
right view by intersecting the matched right segment at the same image
row (rectified stereo ⇒ same v), giving per-endpoint disparity/depth.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import LineConfig
from ..geometry.camera import CameraIntrinsics
from ..ops.hamming import hamming_matrix, knn2
from ..ops.image import bilinear_sample
from ..ops.lbd import lbd_descriptors
from ..ops.lines import DetectedLines, detect_lines, merge_collinear


class LineFeatures(NamedTuple):
    p0: jnp.ndarray      # float32 [L, 2]
    p1: jnp.ndarray      # float32 [L, 2]
    angle: jnp.ndarray   # float32 [L]
    length: jnp.ndarray  # float32 [L]
    desc: jnp.ndarray    # uint8 [L, 32]
    valid: jnp.ndarray   # bool [L]
    depth0: jnp.ndarray  # float32 [L] endpoint-0 depth (-1 invalid)
    depth1: jnp.ndarray  # float32 [L]

    @property
    def n(self) -> int:
        return self.p0.shape[0]


def extract_line_features(img: jnp.ndarray, cfg: LineConfig) -> DetectedLines:
    lines = detect_lines(img, n_lines=cfg.n_lines)
    return merge_collinear(lines)


def _row_intersect(p0, p1, v):
    """x-coordinate where segment (p0,p1) crosses image row v (per pair,
    broadcasting); also whether v lies within the segment's v-extent."""
    y0, y1 = p0[..., 1], p1[..., 1]
    dy = y1 - y0
    tt = (v - y0) / jnp.where(jnp.abs(dy) < 1e-6, 1e-6, dy)
    x = p0[..., 0] + (p1[..., 0] - p0[..., 0]) * tt
    inside = (tt >= -0.05) & (tt <= 1.05)
    return x, inside


@functools.partial(jax.jit, static_argnames=("cfg", "cam"))
def build_line_features(
    img_left: jnp.ndarray,
    img_right: jnp.ndarray,
    cam: CameraIntrinsics,
    cfg: LineConfig,
) -> LineFeatures:
    """Detect + describe lines in the left image; endpoint depths from a
    matched right-image segment (rectified pair)."""
    # Batch the stereo pair through detection + description (one [2,H,W]
    # program — halves the kernel count vs per-image passes, same trick
    # as the point front-end's joint L/R extraction).
    imgs = jnp.stack([img_left, img_right]).astype(jnp.float32)
    from ..ops.image import sobel_gradients

    gxs, gys = sobel_gradients(imgs)
    det = jax.vmap(
        lambda im, gx, gy: detect_lines(im, n_lines=cfg.n_lines, grads=(gx, gy))
    )(imgs, gxs, gys)
    det = jax.vmap(merge_collinear)(det)
    descs = jax.vmap(
        lambda im, p0, p1, v, gx, gy: lbd_descriptors(im, p0, p1, v, grads=(gx, gy))
    )(imgs, det.p0, det.p1, det.valid, gxs, gys)
    ll = jax.tree_util.tree_map(lambda a: a[0], det)
    lr = jax.tree_util.tree_map(lambda a: a[1], det)
    descL, descR = descs[0], descs[1]

    # --- stereo association: Hamming + angle + vertical overlap ---
    dist = hamming_matrix(descL, descR)
    dang = jnp.abs(((ll.angle[:, None] - lr.angle[None, :] + jnp.pi / 2) % jnp.pi) - jnp.pi / 2)
    yl0 = jnp.minimum(ll.p0[:, 1], ll.p1[:, 1])
    yl1 = jnp.maximum(ll.p0[:, 1], ll.p1[:, 1])
    yr0 = jnp.minimum(lr.p0[:, 1], lr.p1[:, 1])
    yr1 = jnp.maximum(lr.p0[:, 1], lr.p1[:, 1])
    ov = jnp.minimum(yl1[:, None], yr1[None, :]) - jnp.maximum(yl0[:, None], yr0[None, :])
    ov_ok = ov > 0.5 * jnp.minimum(yl1 - yl0 + 1.0, 8.0)[:, None]
    gate = (dang < 0.15) & ov_ok & lr.valid[None, :]
    idx, d1, d2 = knn2(dist, gate)
    # Descriptor gate at TH_HIGH: the angle/overlap gates above plus the
    # SAD interior check below are the real verifiers here — LBD Hamming
    # swings ~15 bits under sub-pixel endpoint shifts, so a tight gate
    # drops true stereo pairs (measured on the synthetic stereo scene).
    matched = ll.valid & (d1 < 100) & (d1.astype(jnp.float32) < 0.9 * d2.astype(jnp.float32))

    # Endpoint depths: intersect the matched right segment at each left
    # endpoint's row.  Near-horizontal lines are rejected: with a
    # rectified rig, d(disp)/d(v) = |dx/dy| of the segment, so a line
    # within ~27 deg of horizontal amplifies sub-pixel row noise into
    # meters (the reference's line-stereo has the same blind spot).
    rp0 = lr.p0[idx]
    rp1 = lr.p1[idx]
    max_disp = cam.bf / max(cam.baseline, 1e-6)
    rd = rp1 - rp0
    steep = jnp.abs(rd[:, 0]) < 2.0 * jnp.abs(rd[:, 1])

    def sad_refine(pe, disp0):
        """Sub-pixel disparity at one endpoint row by 1D SAD against the
        right image (the point path's ComputeStereoMatches refinement,
        src/Frame.cc): the segment-intersection estimate inherits both
        detections' lateral noise (~0.5 px), while intensity correlation
        around the initial estimate is anchored to the actual stroke."""
        dx = jnp.arange(-4.0, 5.0)                                   # [9]
        cand = jnp.arange(-4.0, 4.5, 0.5)                            # [17]
        rowL = jnp.stack(
            [pe[:, 0:1] + dx[None, :], jnp.broadcast_to(pe[:, 1:2], (pe.shape[0], 9))],
            axis=-1,
        )                                                            # [L,9,2]
        patchL = bilinear_sample(imgs[0], rowL)                      # [L,9]
        xr0 = pe[:, 0] - disp0
        xs = xr0[:, None, None] + cand[None, :, None] + dx[None, None, :]
        ysr = jnp.broadcast_to(pe[:, 1][:, None, None], xs.shape)
        patchR = bilinear_sample(imgs[1], jnp.stack([xs, ysr], -1))  # [L,7,9]
        sad = jnp.sum(jnp.abs(patchR - patchL[:, None, :]), axis=-1)  # [L,7]
        best = jnp.argmin(sad, axis=1)
        bc = jnp.clip(best, 1, cand.shape[0] - 2)
        sm = jnp.take_along_axis(sad, (bc - 1)[:, None], 1)[:, 0]
        s0 = jnp.take_along_axis(sad, bc[:, None], 1)[:, 0]
        sp = jnp.take_along_axis(sad, (bc + 1)[:, None], 1)[:, 0]
        denom = sm + sp - 2.0 * s0
        frac = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (sm - sp) / jnp.maximum(denom, 1e-6), 0.0)
        frac = jnp.clip(frac, -0.5, 0.5)
        off = (cand[bc] + frac * 0.5)
        # A minimum pinned to the search boundary means the true
        # correlation peak is out of range (occlusion / bad detection).
        interior = (best > 0) & (best < cand.shape[0] - 1)
        return disp0 - off, interior

    def endpoint_depth(pe):
        xr, inside = _row_intersect(rp0, rp1, pe[:, 1])
        disp = pe[:, 0] - xr
        ok = matched & steep & inside & (disp > 0.3) & (disp < max_disp)
        disp_r, interior = sad_refine(pe, disp)
        # Occlusion/ambiguity gate: the intensity-anchored estimate must
        # have an interior correlation minimum — boundary-pinned minima
        # mean the two estimates disagree beyond the search range, the
        # signature of an endpoint on an occluding contour.  Feeding
        # such wrong-depth line landmarks to BA costs real ATE.
        ok = ok & interior & (disp_r > 0.3) & (disp_r < max_disp)
        return jnp.where(ok, cam.bf / jnp.maximum(disp_r, 0.3), -1.0)

    depth0 = endpoint_depth(ll.p0)
    depth1 = endpoint_depth(ll.p1)

    return LineFeatures(
        p0=ll.p0, p1=ll.p1, angle=ll.angle, length=ll.length,
        desc=descL, valid=ll.valid, depth0=depth0, depth1=depth1,
    )
