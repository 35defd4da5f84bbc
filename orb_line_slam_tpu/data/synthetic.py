"""Synthetic stereo scene renderer for dataset-free integration tests.

The reference family has no tests at all (SURVEY.md §4); this module
implements the survey's prescribed synthetic-scene strategy: render
point (and line) landmarks along a known trajectory, run the pipeline,
assert ATE ~ 0.  Rendering is host-side numpy (not part of the device
compute path).  The resampling and line-drawing helpers follow OpenCV's
``resize``, ``warpAffine`` and ``line`` so scenes look as they did when
OpenCV drew them, without needing OpenCV at run time.

Each 3D landmark carries a fixed random 5x5 texture patch so that ORB
descriptors are distinctive and stable across views.
"""

from __future__ import annotations

import numpy as np

from ..geometry.camera import CameraIntrinsics


class SyntheticScene:
    def __init__(
        self,
        cam: CameraIntrinsics,
        n_points: int = 400,
        n_lines: int = 0,
        extent=((-8.0, 8.0), (-4.0, 4.0), (2.0, 40.0)),
        seed: int = 0,
        clear_radius: float = 0.0,
        ground: tuple | None = None,
    ):
        rng = np.random.default_rng(seed)
        self.cam = cam
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.points = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float64)
        if clear_radius > 0.0:
            # Keep a free corridor around the z axis (the camera path):
            # push landmarks inside the tube radially outward, as a real
            # street/corridor has free space along the trajectory.
            xy = self.points[:, :2]
            r = np.linalg.norm(xy, axis=1)
            inside = r < clear_radius
            scale = (clear_radius + rng.uniform(0, 2.0, inside.sum())) / np.maximum(
                r[inside], 1e-6
            )
            xy[inside] *= scale[:, None]
        if ground is not None:
            # Road-surface landmarks (KITTI-like): a fraction of points
            # lies on a textured ground plane y ≈ y0 below the camera,
            # supplying the close features the keyframe policy's
            # tracked-close counters assume (+y is down in camera frame).
            y0, frac = ground
            n_g = int(n_points * frac)
            g = rng.uniform(lo, hi, size=(n_g, 3))
            g[:, 1] = y0 + rng.normal(0.0, 0.05, n_g)
            self.points[:n_g] = g
        # Distinctive textured billboard per landmark with a fixed
        # PHYSICAL size: the projected patch scales with depth, so
        # appearance is geometrically consistent under camera motion
        # (ORB's scale pyramid handles the zoom, as with real texture).
        # Fractal (multi-octave) textures: structure at all scales, so
        # appearance stays correlated at any viewing distance — per-texel
        # white noise would decorrelate under sub-pixel resampling.
        patches = np.zeros((n_points, 64, 64), np.float32)
        for g, amp in ((4, 1.0), (8, 0.6), (16, 0.4), (32, 0.25)):
            grids = rng.uniform(-1, 1, size=(n_points, g, g)).astype(np.float32)
            patches += np.float32(amp) * _resize_linear(grids, 64)
        pmin = patches.min(axis=(1, 2), keepdims=True)
        pmax = patches.max(axis=(1, 2), keepdims=True)
        self.patches = (255 * (patches - pmin) / (pmax - pmin + 1e-6)).astype(np.uint8)
        self.world_size = rng.uniform(0.35, 0.9, size=n_points)
        # Mipmap chain per patch (area-filtered) so minified billboards
        # don't alias frame-to-frame (the bilinear warp has no area filter).
        self.mips = [self.patches] + [
            _resize_area(self.patches, lvl_size) for lvl_size in (32, 16, 8, 4)
        ]
        # Optional per-frame sensor noise (sigma in gray levels): the
        # noise field is independent per render call, which is what
        # degrades frame-to-frame matching the way a real sensor does —
        # the noise-free renderer tracks at ~0.2% drift, too clean to
        # exercise loop closure.
        self.noise_sigma = 0.0
        self._noise_calls = 0
        self.lines = None
        if n_lines:
            starts = rng.uniform(lo, hi, size=(n_lines, 3))
            dirs = rng.normal(size=(n_lines, 3))
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            lengths = rng.uniform(1.0, 4.0, size=(n_lines, 1))
            self.lines = np.stack([starts, starts + dirs * lengths], axis=1)
        self.bg = 110

    def render(self, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
        """Render the left view for camera pose Tcw."""
        return self._render_view(R_cw, t_cw, baseline_shift=0.0)

    def render_stereo(self, R_cw: np.ndarray, t_cw: np.ndarray):
        left = self._render_view(R_cw, t_cw, 0.0)
        right = self._render_view(R_cw, t_cw, self.cam.baseline)
        return left, right

    def render_rgbd(self, R_cw: np.ndarray, t_cw: np.ndarray):
        """Left view + registered depth map in meters (0 = no return),
        as a TUM-style RGB-D sensor would deliver."""
        depth = np.zeros((self.cam.height, self.cam.width), np.float32)
        img = self._render_view(R_cw, t_cw, 0.0, depth_out=depth)
        return img, depth

    def _render_view(self, R_cw, t_cw, baseline_shift, depth_out=None):
        cam = self.cam
        h, w = cam.height, cam.width
        # Flat background: any texture here would be fixed in SCREEN
        # space (not world space) and would corrupt descriptors of
        # features whose sampling pattern overlaps it.
        img = np.full((h, w), self.bg, dtype=np.uint8)

        xc = (R_cw @ self.points.T).T + t_cw
        xc = xc - np.array([baseline_shift, 0.0, 0.0])  # right cam offset
        z = xc[:, 2]
        u = cam.fx * xc[:, 0] / np.where(z > 0.1, z, 1.0) + cam.cx
        v = cam.fy * xc[:, 1] / np.where(z > 0.1, z, 1.0) + cam.cy
        vis = z > 0.5
        order = np.argsort(-z)  # far first so near landmarks overdraw
        for i in order:
            if not vis[i]:
                continue
            s = cam.fx * self.world_size[i] / z[i]  # projected size in px
            if s < 3.0 or s > 600.0:
                continue
            half = s / 2.0
            x0 = int(np.floor(u[i] - half)) - 1
            y0 = int(np.floor(v[i] - half)) - 1
            size = int(np.ceil(s)) + 3
            # Clip the ROI to the image (partially-visible billboards
            # must render their visible part, not vanish).
            cx0, cy0 = max(x0, 0), max(y0, 0)
            cx1, cy1 = min(x0 + size, w), min(y0 + size, h)
            if cx1 - cx0 < 2 or cy1 - cy0 < 2:
                continue
            # Pick the smallest mip level that is >= the projected size.
            mip = self.mips[0]
            for m in self.mips:
                if m.shape[1] >= s:
                    mip = m
                else:
                    break
            patch = mip[i]
            warped = _warp_scaled(
                patch.astype(np.float32), s / patch.shape[1],
                u[i] - half - cx0, v[i] - half - cy0, cx1 - cx0, cy1 - cy0,
            )
            mask = warped >= 0
            roi = img[cy0:cy1, cx0:cx1]
            roi[mask] = warped[mask].astype(np.uint8)
            if depth_out is not None:
                # Billboards are fronto-parallel: constant depth across
                # the patch footprint.
                droi = depth_out[cy0:cy1, cx0:cx1]
                droi[mask] = z[i]

        if self.lines is not None:
            for seg in self.lines:
                pc = (R_cw @ seg.T).T + t_cw - np.array([baseline_shift, 0.0, 0.0])
                # Clip against the z=1 near plane (shorten, don't skip —
                # and never project near-zero depths, which would paint
                # streaks across the whole frame).
                z0, z1 = pc[0, 2], pc[1, 2]
                if z0 < 1.0 and z1 < 1.0:
                    continue
                pc = pc.copy()
                if z0 < 1.0:
                    a = (1.0 - z0) / (z1 - z0)
                    pc[0] = pc[0] + a * (pc[1] - pc[0])
                elif z1 < 1.0:
                    a = (1.0 - z1) / (z0 - z1)
                    pc[1] = pc[1] + a * (pc[0] - pc[1])
                p0 = (
                    cam.fx * pc[0, 0] / pc[0, 2] + cam.cx,
                    cam.fy * pc[0, 1] / pc[0, 2] + cam.cy,
                )
                p1 = (
                    cam.fx * pc[1, 0] / pc[1, 2] + cam.cx,
                    cam.fy * pc[1, 1] / pc[1, 2] + cam.cy,
                )
                _thick_line(
                    img,
                    (int(round(p0[0])), int(round(p0[1]))),
                    (int(round(p1[0])), int(round(p1[1]))),
                    30,
                )
        if self.noise_sigma > 0.0:
            nrng = np.random.default_rng(977 + self._noise_calls)
            self._noise_calls += 1
            img = np.clip(
                img.astype(np.float32)
                + nrng.normal(0.0, self.noise_sigma, img.shape),
                0, 255,
            ).astype(np.uint8)
        return img


def loop_circuit_trajectory(
    n_frames: int, radius: float = 10.0, laps: float = 1.08
):
    """A genuine closed circuit: the camera travels a circle of the
    given radius in the x-z plane, yawing with the tangent, and comes
    back through its starting poses (laps > 1 ⇒ the final keyframes
    literally REVISIT the first ones — the pixels-to-loop-closure
    stimulus the one-way ``circular_trajectory`` cannot produce;
    VERDICT r3 'next round' #2/#3).  Mirrors the reference's loop
    validation on KITTI 00-style circuits (src/LoopClosing.cc).

    Returns [(R_cw, t_cw)] world-to-camera poses; the camera starts at
    the origin looking +z and orbits the circle centered at
    (radius, 0, 0), always heading along the tangent.
    """
    poses = []
    total = 2.0 * np.pi * laps
    for i in range(n_frames):
        yaw = total * i / max(n_frames - 1, 1)
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        # Circle center sits at (0, 0, radius); the camera starts at the
        # origin facing +z and always faces the tangent direction.
        twc = np.array(
            [radius * (1.0 - np.cos(yaw)), 0.0, radius * np.sin(yaw)]
        )
        R_cw = Rwc.T
        t_cw = -Rwc.T @ twc
        poses.append((R_cw, t_cw))
    return poses


def circular_trajectory(n_frames: int, radius: float = 0.0, step: float = 0.3):
    """Forward motion with slight yaw — a KITTI-like segment.

    Returns list of (R_cw, t_cw) world-to-camera poses; camera looks +z.
    """
    poses = []
    for i in range(n_frames):
        yaw = 0.002 * i
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        twc = np.array([radius * np.sin(yaw), 0.0, step * i])
        R_cw = Rwc.T
        t_cw = -Rwc.T @ twc
        poses.append((R_cw, t_cw))
    return poses


# ---------------------------------------------------------------------------
# Resampling and drawing helpers (numpy ports of the OpenCV calls the
# renderer was first written with; tests compare them with OpenCV where it
# is installed).
# ---------------------------------------------------------------------------

_XY_SHIFT = 16  # OpenCV's fixed-point drawing precision
_XY_ONE = 1 << _XY_SHIFT


def _resize_linear(src: np.ndarray, out: int) -> np.ndarray:
    """Bilinear upsampling of float32 [N, g, g] to [N, out, out] with
    half-pixel centres and replicated borders (cv2.INTER_LINEAR)."""
    g = src.shape[-1]
    f = (np.arange(out) + 0.5) * (g / out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    a = (f - i0).astype(np.float32)
    a[i0 < 0] = 0.0
    a[i0 >= g - 1] = 0.0
    i0 = np.clip(i0, 0, g - 1)
    i1 = np.minimum(i0 + 1, g - 1)
    b = np.float32(1.0) - a
    cols = src[..., i0] * b + src[..., i1] * a
    return cols[..., i0, :] * b[:, None] + cols[..., i1, :] * a[:, None]


def _resize_area(src: np.ndarray, out: int) -> np.ndarray:
    """Area (box) downsampling of uint8 [N, n, n] by an integer factor,
    rounded as cv2.INTER_AREA rounds it."""
    n = src.shape[-1]
    k = n // out
    sums = src.reshape(-1, out, k, out, k).astype(np.int64).sum(axis=(2, 4))
    if k == 2:
        return ((sums + 2) >> 2).astype(np.uint8)
    return np.rint(sums / (k * k)).astype(np.uint8)


def _warp_scaled(src, scale, tx, ty, w, h, border=-1.0):
    """Bilinear warp of float32 src by x_dst = scale * x_src + (tx, ty)
    into an h x w window; samples outside src read ``border``
    (cv2.warpAffine with INTER_LINEAR and BORDER_CONSTANT)."""
    inv = np.float32(1.0 / scale)
    fx = np.arange(w, dtype=np.float32) * inv + np.float32(-tx / scale)
    fy = np.arange(h, dtype=np.float32) * inv + np.float32(-ty / scale)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax = (fx - x0).astype(np.float32)[None, :]
    ay = (fy - y0).astype(np.float32)[:, None]
    hs, ws = src.shape
    pad = np.pad(src, 1, constant_values=np.float32(border))

    def at(dy, dx):
        yy = np.clip(y0 + dy, -1, hs)[:, None] + 1
        xx = np.clip(x0 + dx, -1, ws)[None, :] + 1
        return pad[yy, xx]

    p00, p01, p10, p11 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    top = p00 + ax * (p01 - p00)
    bot = p10 + ax * (p11 - p10)
    return (top + ay * (bot - top)).astype(np.float32)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w, h, p1, p2):
    """Clip a fixed-point segment to [0, w-1] x [0, h-1]; returns
    (visible, p1, p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_fixed(img, p1, p2, color):
    """One-pixel 8-connected line between fixed-point endpoints."""
    h, w = img.shape
    ok, (x1, y1), (x2, y2) = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if not ok:
        return
    half = _XY_ONE >> 1
    if abs(x2 - x1) > abs(y2 - y1):
        if x2 < x1:
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv((y2 - y1) * _XY_ONE, abs(x2 - x1) | 1)
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1)
        xs = ((x1 + half) >> _XY_SHIFT) + k
        ys = (y1 + half + step * k) >> _XY_SHIFT
    else:
        if y2 < y1:
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv((x2 - x1) * _XY_ONE, abs(y2 - y1) | 1)
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1)
        ys = ((y1 + half) >> _XY_SHIFT) + k
        xs = (x1 + half + step * k) >> _XY_SHIFT
    xs = np.append(xs, (x2 + half) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> _XY_SHIFT)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = color


def _fill_convex_poly(img, v, color):
    """Scanline fill of a convex polygon with fixed-point vertices, its
    outline drawn first (cv2.fillConvexPoly, LINE_8)."""
    h, w = img.shape
    npts = len(v)
    half = _XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + half) >> _XY_SHIFT, (max(xs) + half) >> _XY_SHIFT
    ymin, ymax = (min(ys) + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Two edge walkers (clockwise / counter-clockwise from the top vertex).
    edge = [
        {"idx": imin, "di": 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
        {"idx": imin, "di": npts - 1, "x": -_XY_ONE, "dx": 0, "ye": ymin},
    ]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % npts
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + half) >> _XY_SHIFT
                if ty > y:
                    xs0, xe0 = v[idx0][0], v[idx][0]
                    e.update(
                        ye=ty, x=xs0, idx=idx,
                        dx=_cdiv((xe0 - xs0) * 2 + (ty - y), 2 * (ty - y)),
                    )
                    break
                idx0 = idx
                idx = (idx + e["di"]) % npts
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xa = (edge[left]["x"] + half) >> _XY_SHIFT
            xb = (edge[right]["x"] + half) >> _XY_SHIFT
            if xb >= 0 and xa < w:
                img[y, max(xa, 0) : min(xb, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, color):
    """Two-pixel-wide line between integer points with round caps
    (cv2.line with thickness 2 and LINE_8)."""
    h, w = img.shape
    p0 = (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT)
    p1 = (p1[0] << _XY_SHIFT, p1[1] << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    if r > np.finfo(np.float64).eps:
        r = _XY_ONE / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(
            img,
            [
                (p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy),
            ],
            color,
        )
    # Radius-1 filled caps: a plus sign at each end.
    for p in (p0, p1):
        cx = (p[0] + (_XY_ONE >> 1)) >> _XY_SHIFT
        cy = (p[1] + (_XY_ONE >> 1)) >> _XY_SHIFT
        for x, y in ((cx - 1, cy), (cx, cy), (cx + 1, cy), (cx, cy - 1), (cx, cy + 1)):
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color
