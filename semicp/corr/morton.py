"""Morton (Z-order) spatial sorting — a data-layout substitute for trees.

The reference gets spatial locality from FLANN kd-trees (pointer
structures XLA cannot express; SURVEY.md §2.1 row "Per-class kd-tree NN
search"). Here locality comes from DATA LAYOUT instead: points sorted
by interleaved-bit Morton code are stored so that each fixed-size tile
of the array covers a compact spatial region. The block-sparse NN
walk (sparse_nn.class_nn_attrs_sparse) then prunes whole tiles by
axis-aligned-bounding-box distance against the correspondence gate —
the asymptotic O(N^2) -> O(N * c) move, with zero pointers and fully
static shapes.

All ops are plain XLA bit arithmetic (jit/vmap/shard_map-safe).
"""

from __future__ import annotations

import jax.numpy as jnp

# 10 bits per axis -> 30-bit codes; at cell>=1 m this spans >=1 km,
# far beyond any single-scan extent (KITTI ~ +-80 m).
_BITS = 10
_INVALID_CODE = jnp.int32(1 << (3 * _BITS))  # sorts after every real code


def _spread3(v):
    """Spread 10 bits of v so there are two zero bits between each
    (standard magic-number bit interleave)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz, valid, cell: float):
    """(3, N) planes + (N,) valid -> (N,) int32 Z-order codes.

    Quantization cell sets locality granularity only — NOT correctness;
    tile pruning uses exact per-tile AABBs, never the codes. Invalid
    points get a sentinel code that sorts after every real one, so a
    Morton argsort keeps them packed at the tail (where their FAR
    coordinates put their tiles out of every gate anyway).
    """
    lo = jnp.min(jnp.where(valid[None, :], xyz, jnp.inf), axis=1)  # (3,)
    lo = jnp.where(jnp.isfinite(lo), lo, 0.0)
    q = jnp.clip(((xyz - lo[:, None]) / cell).astype(jnp.int32), 0, (1 << _BITS) - 1)
    code = _spread3(q[0]) | (_spread3(q[1]) << 1) | (_spread3(q[2]) << 2)
    return jnp.where(valid, code, _INVALID_CODE)


def morton_order(xyz, valid, cell: float):
    """Permutation sorting points by Morton code, invalid last."""
    return jnp.argsort(morton_codes(xyz, valid, cell))


def tile_aabbs(xyz, valid, tile: int):
    """Per-tile axis-aligned bounding boxes over VALID points.

    xyz (3, N) with N % tile == 0 -> (n_tiles, 3) lo and hi. All-invalid
    tiles get lo=+inf / hi=-inf, which makes their box distance to any
    query +inf (auto-pruned).
    """
    n = xyz.shape[1]
    x = xyz.reshape(3, n // tile, tile)
    v = valid.reshape(1, n // tile, tile)
    lo = jnp.min(jnp.where(v, x, jnp.inf), axis=2).T    # (n_tiles, 3)
    hi = jnp.max(jnp.where(v, x, -jnp.inf), axis=2).T
    return lo, hi


def box_dist2(qlo, qhi, tlo, thi):
    """Squared distance between AABB sets: (Q,3)x(T,3) -> (Q,T).

    Zero where boxes overlap; a lower bound on the distance between any
    pair of points drawn from the two boxes (the pruning invariant).
    """
    d = jnp.maximum(0.0, jnp.maximum(qlo[:, None, :] - thi[None, :, :],
                                     tlo[None, :, :] - qhi[:, None, :]))
    d = jnp.where(jnp.isnan(d), 1.0e18, d)   # inf-inf from empty boxes
    d = jnp.minimum(d, 1.0e18)               # keep d^2 finite in f32
    return jnp.sum(d * d, axis=-1)
