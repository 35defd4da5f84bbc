"""Hamming distance on packed 256-bit binary descriptors, as int8 matmuls.

Static-shape JAX replacement for the reference's bit-twiddling popcount
``ORBmatcher::DescriptorDistance`` (src/ORBmatcher.cc, SURVEY.md §2.1
row 11) and the brute-force loops of ``BinaryDescriptorMatcher``.

Two formulations:
  * ``hamming_matrix`` — the matmul path: unpack each 32-byte descriptor to
    a ±1 int8 vector of length 256; then
    ``dist = (256 - a @ b.T) / 2``.  One [N,256]x[256,M] int8 matmul,
    exactly what the systolic array is built for.
  * ``hamming_pairwise`` — elementwise XOR + popcount for aligned pairs.

Descriptors are stored packed as uint8[N, 32] (same layout as OpenCV ORB
rows), LSB-first within each byte.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_BYTES = 32
DESC_BITS = 256

# Matching thresholds mirrored from the reference family
# (ORBmatcher.cc: TH_LOW=50, TH_HIGH=100).
TH_LOW = 50
TH_HIGH = 100


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """uint8[..., 32] -> uint8[..., 256] of {0,1}, LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*desc.shape[:-1], DESC_BITS)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """{0,1}[..., 256] -> packed uint8[..., 32], LSB-first per byte."""
    b = bits.reshape(*bits.shape[:-1], DESC_BYTES, 8).astype(jnp.uint8)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint8)


def to_pm1(desc: jnp.ndarray) -> jnp.ndarray:
    """Packed uint8[..., 32] -> ±1 int8[..., 256] (bit -> 2b-1)."""
    bits = unpack_bits(desc).astype(jnp.int8)
    return (bits << 1) - jnp.int8(1)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distance.

    Args:
      desc_a: packed uint8[N, 32]
      desc_b: packed uint8[M, 32]
    Returns:
      int32[N, M] Hamming distances in [0, 256].

    Uses the ±1 dot-product identity: with a,b ∈ {-1,+1}^256,
    a·b = 256 - 2*hamming, so hamming = (256 - a·b)/2, exact in int32;
    distance of all-padding descriptors is still valid
    (0 vs 0 -> 0), so callers mask by validity separately.
    """
    a = to_pm1(desc_a)
    b = to_pm1(desc_b)
    dot = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (DESC_BITS - dot) >> 1


def hamming_pairwise(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Row-aligned Hamming distance: uint8[..., 32] x uint8[..., 32] ->
    int32[...]. XOR + popcount on the VPU."""
    x = jnp.bitwise_xor(desc_a, desc_b)
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def knn2(dist: jnp.ndarray, valid_cols: jnp.ndarray | None = None):
    """Best and second-best match per row of a distance matrix.

    Args:
      dist: int32[N, M]
      valid_cols: optional bool[M] or bool[N, M]; invalid columns are
        treated as distance 512 (> max possible 256).
    Returns:
      (best_idx int32[N], best_dist int32[N], second_dist int32[N])
    """
    if valid_cols is not None:
        big = jnp.int32(512)
        dist = jnp.where(valid_cols, dist, big)
    # Two-pass min/argmin instead of lax.top_k(k=2): fused reduction
    # passes instead of a per-row sort (which of the two is faster on
    # the GPU is not measured yet).  Semantics are identical: argmin and top_k both break
    # value ties toward the lower index, and masking out the winning
    # INDEX (not value) before the second pass reproduces top_k's
    # second element exactly.
    i1 = jnp.argmin(dist, axis=-1).astype(jnp.int32)
    d1 = jnp.min(dist, axis=-1)
    cols = jnp.arange(dist.shape[-1], dtype=jnp.int32)
    d2 = jnp.min(
        jnp.where(cols == i1[..., None], jnp.int32(1 << 20), dist), axis=-1
    )
    return i1, d1, d2


def mutual_best(dist: jnp.ndarray):
    """Mutual nearest-neighbour mask from a distance matrix [N, M]."""
    best_ab = jnp.argmin(dist, axis=1)
    best_ba = jnp.argmin(dist, axis=0)
    n = dist.shape[0]
    rows = jnp.arange(n)
    return best_ba[best_ab] == rows
