"""Frame construction: the per-frame device program of the front-end.

Static-shape JAX rebuild of the Frame stereo constructor (src/Frame.cc,
SURVEY.md §2.1 row 5, §3.2): dual ORB extraction (batched instead of
the reference's two pthreads), stereo row-band matching with SAD
sub-pixel depth, and keypoint undistortion.  The reference's 64x48
feature grid (AssignFeaturesToGrid/GetFeaturesInArea) has no analog
here by design: windowed candidate lookup is done with dense masked
distance matrices (see matching/point_matcher.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import undistort_points
from ..ops.image import build_pyramid, pyramid_atlas
from .orb_extractor import FrameFeatures, extract_orb
from .stereo import StereoMatch, stereo_match


class Frame(NamedTuple):
    """Per-frame SoA feature state (device arrays, static shapes)."""

    xy: jnp.ndarray        # float32 [N, 2] undistorted level-0 coords
    response: jnp.ndarray  # float32 [N]
    angle: jnp.ndarray     # float32 [N]
    octave: jnp.ndarray    # int32 [N]
    desc: jnp.ndarray      # uint8 [N, 32]
    valid: jnp.ndarray     # bool [N]
    u_right: jnp.ndarray   # float32 [N] (-1 = no stereo match)
    depth: jnp.ndarray     # float32 [N] (-1 = no depth)

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    @property
    def has_depth(self) -> jnp.ndarray:
        return self.valid & (self.depth > 0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_stereo_frame(
    img_left: jnp.ndarray, img_right: jnp.ndarray, cfg: SlamConfig
) -> Frame:
    """Extract features from a rectified stereo pair and compute depths.

    One jitted program per image geometry; both extractions and the
    stereo search compile into a single XLA computation.
    """
    from .orb_extractor import extract_orb_stereo

    featL, tilesL, deltaL, featR, _, atlasR, offsR = extract_orb_stereo(
        img_left, img_right, cfg.orb
    )
    sm = stereo_match(featL, featR, tilesL, deltaL, atlasR, offsR, cfg.camera, cfg.orb)

    xy_und = undistort_points(cfg.camera, featL.xy)
    return Frame(
        xy=xy_und,
        response=featL.response,
        angle=featL.angle,
        octave=featL.octave,
        desc=featL.desc,
        valid=featL.valid,
        u_right=sm.u_right,
        depth=sm.depth,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_rgbd_frame(
    img: jnp.ndarray, depth_map: jnp.ndarray, cfg: SlamConfig
) -> Frame:
    """RGB-D frame: depths read from the registered depth map, synthetic
    u_right = u - bf/depth (mirrors Frame::ComputeStereoFromRGBD)."""
    feat = extract_orb(img, cfg.orb)
    xi = jnp.clip(jnp.round(feat.xy[:, 0]).astype(jnp.int32), 0, depth_map.shape[1] - 1)
    yi = jnp.clip(jnp.round(feat.xy[:, 1]).astype(jnp.int32), 0, depth_map.shape[0] - 1)
    d = depth_map[yi, xi].astype(jnp.float32)
    ok = feat.valid & (d > 0)
    xy_und = undistort_points(cfg.camera, feat.xy)
    return Frame(
        xy=xy_und,
        response=feat.response,
        angle=feat.angle,
        octave=feat.octave,
        desc=feat.desc,
        valid=feat.valid,
        u_right=jnp.where(ok, feat.xy[:, 0] - cfg.camera.bf / jnp.maximum(d, 1e-6), -1.0),
        depth=jnp.where(ok, d, -1.0),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_mono_frame(img: jnp.ndarray, cfg: SlamConfig) -> Frame:
    """Monocular frame: no depth channel."""
    feat = extract_orb(img, cfg.orb)
    n = feat.xy.shape[0]
    xy_und = undistort_points(cfg.camera, feat.xy)
    return Frame(
        xy=xy_und,
        response=feat.response,
        angle=feat.angle,
        octave=feat.octave,
        desc=feat.desc,
        valid=feat.valid,
        u_right=jnp.full((n,), -1.0),
        depth=jnp.full((n,), -1.0),
    )
