"""E-step weights and class reduction.

The reference's per-correspondence Sigma_ik / N(d;0,Sigma) / confusion-
model math (strewn through semantic_icp.hpp's E-step, SURVEY.md §2.2
step 2), with the class axis REDUCED right away, so the M-step never
sees K. For each point i, over the K classes:

  Sigma_ik^{-1} -> Mahalanobis + logdet -> geometric log-lik
  + semantic log-prior -> softmax weight w_ik -> accumulate
      A_i = sum_k w_ik Sigma_ik^{-1}               (6 planes)
      b_i = sum_k w_ik Sigma_ik^{-1} x_ik          (3 planes)
      c_i = sum_k w_ik x_ik^T Sigma_ik^{-1} x_ik   (1 plane)
      wsum_i = sum_k w_ik                          (1 plane)

These four suffice for the whole frozen-correspondence GN inner solve
(residuals.normal_equations_collapsed): with J_i depending only on the
moved source point, H = sum_i J_i^T A_i J_i, g = sum_i J_i^T (b_i -
A_i p_i), cost = sum_i c_i - 2 b_i.p_i + p_i.A_i p_i — exactly equal to
the per-(i,k) sums, K times less M-step bandwidth.

Inputs arrive as the NN search's outputs (d2 (K,N), attrs (K,16,N)) plus
loop-invariant planes. The whole reduce is elementwise math over K with
one reduction over K, which XLA fuses into one pass over its inputs.
"""

from __future__ import annotations

import jax.numpy as jnp

NEG = -3.0e37
INF = 3.0e37


def estep_weights(sigma, d, log_sem, mask):
    """Un-reduced (K,N) softmax weights and Sigma^{-1} planes."""
    from semicp.geom import sym3
    from semicp.register.residuals import gaussian_loglik_planar

    sig_t = tuple(sigma[i] for i in range(6))
    d_t = tuple(d[i] for i in range(3))
    loglik = gaussian_loglik_planar(sig_t, d_t) + log_sem
    loglik = jnp.where(mask > 0.5, loglik, NEG)
    mx = jnp.max(loglik, axis=0, keepdims=True)
    safe_mx = jnp.maximum(mx, NEG * 0.5)
    unnorm = jnp.where(mask > 0.5, jnp.exp(loglik - safe_mx), 0.0)
    tot = jnp.sum(unnorm, axis=0, keepdims=True)
    w = jnp.where(tot > 0.0, unnorm / jnp.maximum(tot, 1e-30), 0.0)
    sinv = jnp.stack(sym3.inv(sig_t), 0)
    return w, sinv


def estep_reduce(nn_d2, attrs, rc6, moved, log_sem, valid, gate2):
    """Weights + class reduction (see the module docstring).

    nn_d2 (K,N), attrs (K,16,N) — the NN search's outputs;
    rc6 (6,N) rotated source covariance; moved (3,N) = T z;
    log_sem (K,N) semantic log-prior; valid (N,) bool source mask;
    gate2 = max correspondence distance SQUARED (may be traced).

    Returns (A (6,N), b (3,N), c (N), wsum (N)).
    """
    x_pl = tuple(attrs[:, i, :] for i in range(3))         # (K,N) planes
    cx = tuple(attrs[:, 3 + i, :] for i in range(6))
    sigma = jnp.stack([c + r[None, :] for c, r in zip(cx, rc6)])
    d = jnp.stack([xp - mv[None, :] for xp, mv in zip(x_pl, moved)])
    exact_d2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    gate = ((exact_d2 <= gate2) & (nn_d2 < INF)
            & valid[None, :]).astype(jnp.float32)
    w, sinv = estep_weights(sigma, d, log_sem, gate)
    # explicit multiply + sum over K (not einsum): a contraction with N
    # as a batch dimension must stay an elementwise fusion, not become
    # N tiny batched matrix products
    a6 = jnp.sum(w[None] * sinv, axis=1)
    t = jnp.stack([
        sinv[0] * x_pl[0] + sinv[3] * x_pl[1] + sinv[4] * x_pl[2],
        sinv[3] * x_pl[0] + sinv[1] * x_pl[1] + sinv[5] * x_pl[2],
        sinv[4] * x_pl[0] + sinv[5] * x_pl[1] + sinv[2] * x_pl[2],
    ])                                                     # (3,K,N)
    b3 = jnp.sum(w[None] * t, axis=1)
    c = jnp.sum(w * (x_pl[0] * t[0] + x_pl[1] * t[1] + x_pl[2] * t[2]), axis=0)
    wsum = jnp.sum(w, axis=0)
    return a6, b3, c, wsum
