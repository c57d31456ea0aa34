"""Radius-neighbourhood moments for GICP covariances.

Preprocessing redesign (SURVEY.md §3.4): instead of a kNN search (full
row distances + top_k + neighbour gathers), each point's neighbourhood
(same class & dist < radius & valid) is summarised by ten masked moments

    n, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz

from which the covariance follows in a cheap epilogue (C = S2/n - mean
mean^T, then the rank-1 GICP clamp, sym3.regularize).

Semantics note: the reference uses k=20 nearest neighbours; this uses a
fixed radius. After the (1,1,eps) eigenvalue clamp only the eigenvector
frame survives, and on locally planar/structured geometry both
neighbourhoods estimate the same frame — the numpy oracle supports both
(OracleParams.cov_method) so parity is tested like-for-like.

Two implementations of one contract: `neighborhood_moments_xla`, a dense
O(N^2) sweep (the reference, and the path for raw-layout clouds), and
`neighborhood_moments_sparse`, a walk over the candidate tiles of a
class-major Morton cloud (the path every driver takes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NMOM = 10
QB = 128   # query tile of the sparse walk (not tuned on the H100)
TB = 256   # target tile of the sparse walk (not tuned on the H100)


def _features(x, y, z):
    """(..., T) coordinates -> (..., 10, T) moment features."""
    return jnp.stack([jnp.ones_like(x), x, y, z, x * x, y * y, z * z,
                      x * y, x * z, y * z], axis=-2)


def neighborhood_moments_xla(xyz, label, valid, radius, qb: int = 512):
    """(10, N) masked neighbourhood moments of every point (self-inclusive),
    by a dense sweep of query blocks against the whole cloud."""
    n = xyz.shape[1]
    qb = min(qb, n)
    tx, ty, tz = xyz[0], xyz[1], xyz[2]
    t2 = tx * tx + ty * ty + tz * tz
    lab = jnp.where(valid, label, -1).astype(jnp.int32)
    # invalid queries get label -2 so they never match anything (their
    # covariance falls back to identity via the count check)
    qlab_all = jnp.where(valid, label, -2).astype(jnp.int32)
    r2 = jnp.asarray(radius, jnp.float32) ** 2
    feats = _features(tx, ty, tz)                          # (10, N)

    def block(args):
        bqx, bqy, bqz, bq2, blab = args
        d2 = _dist2(bqx[:, None], bqy[:, None], bqz[:, None], bq2[:, None],
                    tx[None, :], ty[None, :], tz[None, :], t2[None, :])
        w = ((d2 < r2) & (blab[:, None] == lab[None, :])).astype(jnp.float32)
        return jnp.einsum("qn,mn->mq", w, feats,
                          precision=jax.lax.Precision.HIGHEST)

    blocks = (tx.reshape(-1, qb), ty.reshape(-1, qb), tz.reshape(-1, qb),
              t2.reshape(-1, qb), qlab_all.reshape(-1, qb))
    out = jax.lax.map(block, blocks)                       # (n/qb, 10, qb)
    return jnp.moveaxis(out, 1, 0).reshape(NMOM, n)


def _dist2(qx, qy, qz, q2, tx, ty, tz, t2):
    """Expanded squared distance, elementwise. Both moment paths decide
    membership (d2 < r^2) with this same per-pair arithmetic, so they
    agree on every point at the radius boundary."""
    return q2 + t2 - 2.0 * (qx * tx + qy * ty + qz * tz)


@functools.partial(jax.jit, static_argnames=("num_classes", "qb", "tb"))
def neighborhood_moments_sparse(xyz, label, valid, radius, num_classes: int,
                                qb: int = QB, tb: int = TB):
    """Masked neighbourhood moments over a cm-sorted cloud, by tiles.

    Requires canonical class-major Morton layout (corr.layout) so tile
    AABB + class-range pruning applies: the candidates of a query tile
    are the same-class target tiles within `radius` (a few at scan
    density). One loop step per candidate slot, up to the largest count:
    each step gathers one target tile per query tile and adds a masked
    (10 x tb) . (tb x qb) product. Nothing is dropped.

    Returns (10, N) moments of per-query-tile CENTRED coordinates —
    identical covariances through the standard epilogue (translation
    invariance), NOT bitwise-equal raw moments.
    """
    from semicp.corr.layout import tile_candidates, tile_meta

    n = xyz.shape[1]
    qb = min(qb, n)
    tb = min(tb, n)
    if n % qb or n % tb:
        raise ValueError(
            f"moments: N={n} must be a multiple of qb={qb} and tb={tb}")
    n_qt, n_tt = n // qb, n // tb

    qmeta = tile_meta(xyz, label, valid, num_classes, qb)
    tmeta = tile_meta(xyz, label, valid, num_classes, tb)
    cand, count = tile_candidates(
        qmeta["lo"], qmeta["hi"], tmeta["lo"], tmeta["hi"], radius,
        q_range=(qmeta["cmin"], qmeta["cmax"]),
        t_range=(tmeta["cmin"], tmeta["cmax"]),
    )
    # Centre both tiles on the query tile's AABB midpoint: moments of
    # centred coordinates keep Sxx ~ O(r^2) instead of O(40m^2), so the
    # f32 epilogue (S2/n - mean^2) loses no digits to cancellation.
    ctr = 0.5 * (qmeta["lo"] + qmeta["hi"])
    ctr = jnp.where(jnp.isfinite(ctr), ctr, 0.0)[:, :, None]  # (n_qt, 3, 1)
    qt = xyz.reshape(3, n_qt, qb).transpose(1, 0, 2)          # (n_qt, 3, qb)
    q2 = jnp.sum(qt * qt, axis=1)                             # (n_qt, qb)
    qlab = jnp.where(valid, label, -2).reshape(n_qt, qb)
    tt = xyz.reshape(3, n_tt, tb).transpose(1, 0, 2)          # (n_tt, 3, tb)
    tlab = jnp.where(valid, label, -1).reshape(n_tt, tb)
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def slot(c, acc):
        tid = cand[:, c]
        t = tt[tid]                                            # (n_qt, 3, tb)
        d2 = _dist2(qt[:, 0, :, None], qt[:, 1, :, None], qt[:, 2, :, None],
                    q2[:, :, None], t[:, 0, None, :], t[:, 1, None, :],
                    t[:, 2, None, :], jnp.sum(t * t, axis=1)[:, None, :])
        w = ((d2 < r2) & (qlab[:, :, None] == tlab[tid][:, None, :])
             & (c < count)[:, None, None])                     # (n_qt, qb, tb)
        t = t - ctr
        feats = _features(t[:, 0], t[:, 1], t[:, 2])           # (n_qt, 10, tb)
        return acc + jnp.einsum("nmt,nqt->nmq", feats, w.astype(jnp.float32),
                                precision=jax.lax.Precision.HIGHEST)

    acc = jax.lax.fori_loop(0, jnp.max(count), slot,
                            jnp.zeros((n_qt, NMOM, qb), jnp.float32))
    return jnp.moveaxis(acc, 1, 0).reshape(NMOM, n)


def neighborhood_moments(xyz, label, valid, radius, num_classes=None,
                         layout: str = "raw"):
    """The sparse walk for cm-sorted clouds on an accelerator; the dense
    sweep otherwise (on the CPU backend it is the engine, as the brute
    force is for the NN search)."""
    if (layout == "cm" and num_classes is not None
            and jax.default_backend() != "cpu"):
        return neighborhood_moments_sparse(xyz, label, valid, radius,
                                           num_classes)
    return neighborhood_moments_xla(xyz, label, valid, radius)
