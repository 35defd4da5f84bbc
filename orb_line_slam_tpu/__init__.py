"""orb_line_slam_tpu — a JAX stereo point+line SLAM engine.

Built from scratch in JAX/XLA with the capabilities of
robotseu/ORB_Line_SLAM (an ORB-SLAM2-derived point+line system; see
SURVEY.md for the structural analysis of the reference).

Design stance (SURVEY.md §7.0):
  - SoA + static shapes everywhere; deletion = mask clear.
  - Batched, masked, fixed-K kernels replace dynamic loops.
  - The reference's three pthreads become two rates, one device program
    each: per-frame ``track_step`` and per-keyframe ``map_step``.
"""

__version__ = "0.1.0"
