"""Correspondence engine exactness vs numpy brute force (SURVEY.md §4.2).

The brute-force engine (corr/bruteforce.py) is the semantic ground
truth for every faster path: the block-sparse walk is tested against it
in test_pallas.py;
here the engine itself is pinned against an O(N^2) numpy oracle, and
the Morton tiling utilities are pinned against their invariants.
"""

import jax.numpy as jnp
import numpy as np

from semicp.corr.bruteforce import class_nn, knn_self
from semicp.corr.morton import box_dist2, morton_order, tile_aabbs


def test_class_nn_matches_numpy(rng):
    N, K = 1024, 5
    pts = (rng.normal(size=(N, 3)) * np.array([15, 15, 2])).astype(np.float32)
    labels = rng.integers(0, K, size=N).astype(np.int32)
    valid = rng.uniform(size=N) > 0.1
    q = (pts[:256] + rng.normal(size=(256, 3)) * 0.4).astype(np.float32)

    idx, d2 = class_nn(jnp.asarray(pts.T), jnp.asarray(labels),
                       jnp.asarray(valid), jnp.asarray(q.T), num_classes=K)
    idx, d2 = np.asarray(idx), np.asarray(d2)
    for k in range(K):
        m = (labels == k) & valid
        if not m.any():
            assert (d2[k, :] > 1e30).all()
            continue
        bf = np.sum((pts[m][None] - q[:, None]) ** 2, -1)  # (Q, n_k)
        np.testing.assert_allclose(d2[k], bf.min(1), rtol=1e-4, atol=1e-3)
        assert (labels[idx[k]] == k).all()


def test_knn_self_matches_numpy(rng):
    N, k = 512, 8
    pts = rng.normal(size=(N, 3)).astype(np.float32) * 5
    labels = np.zeros(N, np.int32)
    valid = np.ones(N, bool)
    idx, d2, nv = knn_self(jnp.asarray(pts.T), jnp.asarray(labels),
                           jnp.asarray(valid), k=k)
    d2 = np.asarray(d2)
    for i in range(0, N, 37):
        bf = np.sort(np.sum((pts - pts[i]) ** 2, -1))[:k]
        np.testing.assert_allclose(np.sort(d2[i]), bf, rtol=1e-4, atol=1e-4)


def test_morton_order_locality(rng):
    """Morton-sorted tiles must cover compact regions: the mean per-tile
    AABB diagonal is far below the scene diagonal."""
    N = 4096
    pts = rng.uniform(-20, 20, size=(3, N)).astype(np.float32)
    valid = np.ones(N, bool)
    order = np.asarray(morton_order(jnp.asarray(pts), jnp.asarray(valid), 1.0))
    srt = pts[:, order]

    def mean_diag(arr):
        lo, hi = tile_aabbs(jnp.asarray(arr), jnp.asarray(valid), 256)
        return np.linalg.norm(np.asarray(hi) - np.asarray(lo), axis=1).mean()

    # vs the unsorted (scan-order-random) layout, where every tile spans
    # nearly the whole scene
    assert mean_diag(srt) < 0.8 * mean_diag(pts)


def test_morton_invalid_sorts_last(rng):
    N = 1024
    pts = rng.normal(size=(3, N)).astype(np.float32)
    valid = np.arange(N) % 3 != 0
    order = np.asarray(morton_order(jnp.asarray(pts), jnp.asarray(valid), 1.0))
    v_sorted = valid[order]
    n_valid = valid.sum()
    assert v_sorted[:n_valid].all() and not v_sorted[n_valid:].any()


def test_box_dist2_lower_bounds_point_dist(rng):
    """The pruning invariant: box distance lower-bounds any point pair."""
    a = rng.uniform(-5, 5, size=(64, 3)).astype(np.float32)
    b = rng.uniform(-5, 5, size=(64, 3)).astype(np.float32)
    qlo, qhi = a - 0.5, a + 0.5
    tlo, thi = b - 0.5, b + 0.5
    bd2 = np.asarray(box_dist2(jnp.asarray(qlo), jnp.asarray(qhi),
                               jnp.asarray(tlo), jnp.asarray(thi)))
    pd2 = np.sum((a[:, None] - b[None]) ** 2, -1)
    assert (bd2 <= pd2 + 1e-4).all()
