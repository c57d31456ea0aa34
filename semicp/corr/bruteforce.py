"""Brute-force correspondence engine — every query against every target.

The exact reference for the block-sparse walk (corr/sparse_nn.py) and
the correspondence engine on the CPU backend (SURVEY.md §2.1 row
"Per-class kd-tree NN search"). Its work is quadratic: Q x N distances
and K masked minima per pair, so it is for tests, small clouds and
reference checks, not for scan-scale EM on the accelerator.

Scheme: tile queries (QB) x targets (TB); per tile compute
    d2 = |q|^2 + |t|^2 - 2 q . t        (dot_general, f32 HIGHEST)
and fold it into running per-class (min, argmin) carries — the (QB,TB)
block lives only inside the fused loop body, never in HBM. Per-class
selection is a masked min over the tile (classes stay data, not
structure). Gathers survive only at O(Q) for the winners.

Numerical note: the expansion loses ~|x|^2 * 2^-23 of absolute d2
precision to cancellation (~1e-3 m^2 at KITTI's +-80 m extent) — harmless
for EM weighting, and the subsequent residual math recomputes exact
differences from the gathered winner coordinates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

INF = jnp.float32(3.0e37)

# Tile sizes: one (QB, TB) block of the distance matrix lives inside the
# fused loop body; the values have not been tuned on the H100.
QB = 512
TB = 512


def _dist2_block(qx, qy, qz, q2, tx, ty, tz, t2):
    """(QB,) query planes x (TB,) target planes -> (QB, TB) distances."""
    q = jnp.stack([qx, qy, qz], -1)                  # (QB, 3)
    t = jnp.stack([tx, ty, tz], -1)                  # (TB, 3)
    g = jax.lax.dot_general(
        q, t, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )                                                # (QB, TB)
    return q2[:, None] + t2[None, :] - 2.0 * g


@functools.partial(jax.jit, static_argnames=("num_classes", "qb", "tb"))
def class_nn(tgt_xyz, tgt_label, tgt_valid, q_xyz, num_classes: int,
             qb: int = QB, tb: int = TB):
    """Exact per-class nearest neighbor for every query point.

    tgt_xyz: (3, N) planes; tgt_label: (N,) int32; tgt_valid: (N,) bool;
    q_xyz: (3, Q) planes. N and Q must be multiples of tb/qb (pad-safe:
    invalid targets get INF distance, extra queries are harmless).

    Returns (idx (K, Q) int32, d2 (K, Q) f32) — d2 == INF where a class
    has no valid target.
    """
    K = num_classes
    n = tgt_xyz.shape[1]
    q = q_xyz.shape[1]
    qb = min(qb, q)
    tb = min(tb, n)
    tx, ty, tz = tgt_xyz[0], tgt_xyz[1], tgt_xyz[2]
    t2 = tx * tx + ty * ty + tz * tz
    qx, qy, qz = q_xyz[0], q_xyz[1], q_xyz[2]
    q2 = qx * qx + qy * qy + qz * qz

    n_tiles = n // tb

    def query_block(args):
        bqx, bqy, bqz, bq2 = args

        def tile_body(ti, carry):
            best_d2, best_idx = carry                # (K, QB) each
            s = ti * tb
            ttx = jax.lax.dynamic_slice_in_dim(tx, s, tb)
            tty = jax.lax.dynamic_slice_in_dim(ty, s, tb)
            ttz = jax.lax.dynamic_slice_in_dim(tz, s, tb)
            tt2 = jax.lax.dynamic_slice_in_dim(t2, s, tb)
            tlab = jax.lax.dynamic_slice_in_dim(tgt_label, s, tb)
            tval = jax.lax.dynamic_slice_in_dim(tgt_valid, s, tb)
            d2 = _dist2_block(bqx, bqy, bqz, bq2, ttx, tty, ttz, tt2)
            d2 = jnp.where(tval[None, :], d2, INF)

            new_d2, new_idx = [], []
            for k in range(K):                        # static unroll over classes
                dk = jnp.where(tlab[None, :] == k, d2, INF)
                m = jnp.min(dk, axis=1)
                # tile-local argmin + tile offset == global index (no gather)
                a = jnp.argmin(dk, axis=1).astype(jnp.int32) + s
                better = m < best_d2[k]
                new_d2.append(jnp.where(better, m, best_d2[k]))
                new_idx.append(jnp.where(better, a, best_idx[k]))
            return jnp.stack(new_d2), jnp.stack(new_idx)

        init = (jnp.full((K, qb), INF), jnp.zeros((K, qb), jnp.int32))
        return jax.lax.fori_loop(0, n_tiles, tile_body, init)

    blocks = (
        qx.reshape(-1, qb), qy.reshape(-1, qb), qz.reshape(-1, qb), q2.reshape(-1, qb)
    )
    d2_b, idx_b = jax.lax.map(query_block, blocks)    # (Q/qb, K, qb)
    d2 = jnp.moveaxis(d2_b, 1, 0).reshape(K, q)
    idx = jnp.moveaxis(idx_b, 1, 0).reshape(K, q)
    return idx, d2


@functools.partial(jax.jit, static_argnames=("k", "qb", "tb", "class_aware"))
def knn_self(xyz, label, valid, k: int, class_aware: bool = True,
             qb: int = QB, tb: int = TB):
    """k nearest neighbors of every point within its own cloud (and, when
    class_aware, its own semantic class) — the covariance neighborhood
    (SURVEY.md §2.2 step 1). Self-inclusive, like the reference's kNN.

    Returns (idx (N, k) int32, d2 (N, k) f32, nvalid (N, k) bool).
    Streaming top-k: per target tile, lax.top_k of the tile merged with
    the running candidate set.
    """
    n = xyz.shape[1]
    qb = min(qb, n)
    tx, ty, tz = xyz[0], xyz[1], xyz[2]
    t2 = tx * tx + ty * ty + tz * tz

    def query_block(args):
        bqx, bqy, bqz, bq2, blab = args
        # full-row distances for this query block: (qb, n), one top_k
        d2 = _dist2_block(bqx, bqy, bqz, bq2, tx, ty, tz, t2)
        ok = valid[None, :]
        if class_aware:
            ok = ok & (label[None, :] == blab[:, None])
        d2 = jnp.where(ok, d2, INF)
        neg, pos = jax.lax.top_k(-d2, k)
        return -neg, pos.astype(jnp.int32)

    blocks = (
        xyz[0].reshape(-1, qb), xyz[1].reshape(-1, qb), xyz[2].reshape(-1, qb),
        t2.reshape(-1, qb), label.reshape(-1, qb),
    )
    d2_b, idx_b = jax.lax.map(query_block, blocks)
    d2 = d2_b.reshape(n, k)
    idx = idx_b.reshape(n, k)
    return idx, d2, d2 < INF
