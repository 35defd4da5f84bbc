"""Spatially-distributed keypoint selection: per-cell top-K + global top-N.

Static-shape JAX replacement for ORBextractor::DistributeOctTree (the
sequential quadtree in src/ORBextractor.cc, SURVEY.md §2.1 row 9).  The
octree's goal is spatial uniformity under a feature budget; we get the
same effect with static shapes: partition the score map into fixed
cells, keep the K best responses per cell, then keep the global top-N
of the surviving candidates.  Everything is lax.top_k over reshaped
views — no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def select_topk_grid(
    score: jnp.ndarray,
    cell: int,
    k_per_cell: int,
    n_total: int,
    min_score: float,
):
    """Select up to n_total keypoints from a dense score map.

    Args:
      score: float32 [H, W], 0 where not a corner (post-NMS).
      cell: cell side in pixels.
      k_per_cell: candidates kept per cell.
      n_total: final (padded) keypoint budget.
      min_score: minimum score to be valid.

    Returns:
      xy: int32 [n_total, 2] (x, y) pixel coords (0 where invalid)
      resp: float32 [n_total] responses
      valid: bool [n_total]
    """
    h, w = score.shape
    hc = -(-h // cell)
    wc = -(-w // cell)
    pad_h, pad_w = hc * cell - h, wc * cell - w
    s = jnp.pad(score, ((0, pad_h), (0, pad_w)), constant_values=0.0)
    # [hc, cell, wc, cell] -> [hc*wc, cell*cell]
    cells = s.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(
        hc * wc, cell * cell
    )
    vals, idx = jax.lax.top_k(cells, k_per_cell)  # [ncells, k]

    # Decode flat in-cell index -> global (x, y).
    cy = idx // cell
    cx = idx % cell
    cell_ids = jnp.arange(hc * wc, dtype=jnp.int32)[:, None]
    gy = (cell_ids // wc) * cell + cy
    gx = (cell_ids % wc) * cell + cx

    flat_vals = vals.reshape(-1)
    flat_x = gx.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_valid = (flat_vals > min_score) & (flat_x < w) & (flat_y < h)
    keyed = jnp.where(flat_valid, flat_vals, -jnp.inf)

    n_cand = keyed.shape[0]
    if n_cand < n_total:
        padn = n_total - n_cand
        keyed = jnp.pad(keyed, (0, padn), constant_values=-jnp.inf)
        flat_x = jnp.pad(flat_x, (0, padn))
        flat_y = jnp.pad(flat_y, (0, padn))
        flat_vals = jnp.pad(flat_vals, (0, padn))
    top_vals, top_idx = jax.lax.top_k(keyed, n_total)
    xy = jnp.stack([flat_x[top_idx], flat_y[top_idx]], axis=-1)
    resp = flat_vals[top_idx]
    valid = jnp.isfinite(top_vals)
    xy = jnp.where(valid[:, None], xy, 0)
    resp = jnp.where(valid, resp, 0.0)
    return xy.astype(jnp.int32), resp, valid
