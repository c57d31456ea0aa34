"""Canonical cloud layout: class-major + Morton-within-class sort.

The substitute for BOTH of the reference's spatial structures —
per-class FLANN kd-trees (expected usage in semantic_icp.hpp, SURVEY.md
§2.1 row "Per-class kd-tree NN search") and the per-point kNN pass of
covariance estimation (SURVEY.md §2.2 step 1) — is one data layout:

  sort points by (class, Morton code), invalid last.

Consequences the kernels exploit:
  * Within any fixed-size tile of the sorted array, labels are
    NON-DECREASING, so a tile's classes form the contiguous range
    [cmin, cmax] (usually a single class; 2+ only at class boundaries).
    The block-sparse NN walk loops over exactly that range — no
    K-wide static unroll, compile cost and run cost independent of the
    class count.
  * Each tile covers a compact region OF ONE CLASS, so per-tile AABBs
    prune by the correspondence gate (NN) or by radius + class-range
    overlap (covariance) — the O(N^2) -> O(N * c) move with zero
    pointers and fully static shapes.

Sorting happens ONCE per cloud at preprocess time (covariance
estimation shares the layout), marked by `Cloud.layout == "cm"`; align
then skips its own per-align sorts. The sort is one lexicographic sort
over (class, Morton code): 20 classes x 30 Morton bits do not fit an
int32 key, and the package runs with 32-bit types.
"""

from __future__ import annotations

import jax.numpy as jnp

from semicp.cloud.cloud import Cloud
from semicp.corr.morton import morton_codes, tile_aabbs, box_dist2

LAYOUT_CM = "cm"  # class-major, Morton-within-class, invalid last


def class_morton_order(xyz, label, valid, num_classes: int, cell: float):
    """Permutation sorting by (class, Morton), invalid last (class = K).

    One lexicographic lax.sort over (class, code) — 20 classes x 30
    Morton bits exceed an int32 key, and a two-key sort needs no wider
    one.
    """
    import jax

    code = morton_codes(xyz, valid, cell)
    cls = jnp.where(valid, jnp.maximum(label, 0), num_classes).astype(jnp.int32)
    iota = jnp.arange(cls.shape[0], dtype=jnp.int32)
    _, _, perm = jax.lax.sort((cls, code, iota), num_keys=2, is_stable=True)
    return perm


def sort_cloud_cm(cloud: Cloud, num_classes: int, cell: float) -> Cloud:
    """Return the cloud in canonical class-major Morton order."""
    order = class_morton_order(cloud.xyz, cloud.label, cloud.valid,
                               num_classes, cell)
    return cloud.replace(
        xyz=jnp.take(cloud.xyz, order, axis=1),
        label=jnp.take(cloud.label, order),
        cov6=jnp.take(cloud.cov6, order, axis=1),
        valid=jnp.take(cloud.valid, order),
        layout=LAYOUT_CM,
    )


def tile_meta(xyz, label, valid, num_classes: int, tile: int) -> dict:
    """Per-tile metadata over a cm-sorted cloud (loop-invariant, cheap).

    Returns lo/hi (n_t, 3) exact AABBs over valid points and
    cmin/cmax (n_t,) int32 class ranges (cmin > cmax for all-invalid
    tiles, whose AABBs are +-inf and prune against any gate anyway).
    """
    n = xyz.shape[1]
    assert n % tile == 0, (
        f"tile_meta: N={n} must be a multiple of the tile size {tile}")
    lo, hi = tile_aabbs(xyz, valid, tile)
    lab = jnp.where(valid, jnp.maximum(label, 0), -1).reshape(-1, tile)
    cmax = jnp.max(lab, axis=1).astype(jnp.int32)
    cmin = jnp.min(jnp.where(lab >= 0, lab, num_classes), axis=1).astype(jnp.int32)
    return {"lo": lo, "hi": hi, "cmin": cmin, "cmax": cmax}


def tile_candidates(qlo, qhi, tlo, thi, gate, q_range=None, t_range=None):
    """Per-query-tile candidate target-tile lists under a distance gate.

    Exactness invariant: box_dist2 lower-bounds every point-pair
    distance between two tiles, so a tile beyond the gate cannot hold
    any correspondence the caller would accept (SURVEY.md §7 hard part
    #1, restated for tiles). `gate` may be a traced scalar.

    q_range/t_range: optional (cmin, cmax) pairs; when given, tiles
    whose class ranges do not overlap the query tile's are also pruned
    (used by same-class covariance neighborhoods).

    Returns (cand (n_qt, n_tt) int32 — the candidates' tile ids in
    ascending order in the first count[i] slots, the rest 0 — and
    count (n_qt,) int32). Nothing is dropped.
    """
    bd2 = box_dist2(qlo, qhi, tlo, thi)                      # (n_qt, n_tt)
    gate2 = gate * gate * (1.0 + 1e-5) + 1e-6
    mask = bd2 <= gate2
    if q_range is not None and t_range is not None:
        qmin, qmax = q_range
        tmin, tmax = t_range
        mask = mask & (qmin[:, None] <= tmax[None, :]) \
                    & (tmin[None, :] <= qmax[:, None])
    n_qt, n_tt = mask.shape
    count = jnp.sum(mask, axis=1).astype(jnp.int32)
    # compaction: each candidate goes to its rank among its row's
    # candidates (a scatter, not a sort of the whole matrix)
    slot = jnp.where(mask, jnp.cumsum(mask, axis=1) - 1, n_tt)
    tid = jnp.broadcast_to(jnp.arange(n_tt, dtype=jnp.int32), (n_qt, n_tt))
    rows = jnp.broadcast_to(jnp.arange(n_qt)[:, None], (n_qt, n_tt))
    cand = jnp.zeros((n_qt, n_tt), jnp.int32).at[rows, slot].set(
        tid, mode="drop")
    return cand, count
