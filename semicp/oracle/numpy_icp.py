"""CPU-numpy oracle: a literal, readable implementation of SURVEY.md §2.2.

This is the executable specification of the reference algorithm
(Semantic-ICP through EM, Parkison et al. BMVC 2018; expected reference
files include/semantic_icp/semantic_icp.hpp + gicp_cost_function.h). It
replaces the unavailable C++ binary as the parity ground-truth oracle
(SURVEY.md §4.7) and doubles as the CPU baseline for the >=10x
scans/s/chip target (BASELINE.json:5).

Deliberately un-clever: brute-force per-class NN, dense per-point math,
explicit loops over EM iterations. Everything the accelerator path does
with tiles, masks and fused kernels must agree with THIS code on small
problems to the documented tolerances.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class OracleParams:
    # §2.2 step 1 — covariance estimation
    cov_k: int = 20
    cov_eps: float = 1e-3
    class_aware_cov: bool = True
    cov_method: str = "knn"      # "knn" (reference) | "radius" (the fast path)
    cov_radius: float = 0.8
    # §2.2 step 2 — E-step
    max_dist: float = 2.0
    alpha: float = 0.85          # P(observed label correct)
    uniform_semantics: bool = False
    # §2.2 step 3 — M-step (GN with LM damping, replaces Ceres)
    gn_iters: int = 8
    lm_lambda: float = 1e-6
    # §2.2 step 4 — convergence
    max_iters: int = 30
    trans_eps: float = 1e-4


def _se3_exp_np(delta: np.ndarray) -> np.ndarray:
    """exp: R^6 [v, w] -> 4x4. Same convention as semicp.geom.se3."""
    v, w = delta[:3], delta[3:]
    theta = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-8:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(theta) / theta * W + (1 - np.cos(theta)) / theta**2 * W2
        V = (np.eye(3) + (1 - np.cos(theta)) / theta**2 * W
             + (theta - np.sin(theta)) / theta**3 * W2)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def _se3_log_np(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-8:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
        Vinv = np.eye(3) - 0.5 * _hat(w)
    else:
        w = theta / (2 * np.sin(theta)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
        W = _hat(w)
        Vinv = (np.eye(3) - 0.5 * W
                + (1 / theta**2 - (1 + np.cos(theta)) / (2 * theta * np.sin(theta))) * W @ W)
    return np.concatenate([Vinv @ t, w])


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def estimate_covariances_np(
    xyz: np.ndarray, labels: np.ndarray, p: OracleParams
) -> np.ndarray:
    """§2.2 step 1: k-NN empirical covariance, eigenvalues clamped to (1,1,eps).

    Matches the reference's per-label sub-cloud kNN when class_aware_cov
    (the per-label kd-trees only contain same-label points).
    """
    n = len(xyz)
    covs = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        if p.class_aware_cov:
            mask = labels == labels[i]
            pool = xyz[mask]
        else:
            pool = xyz
        d2 = np.sum((pool - xyz[i]) ** 2, -1)
        if p.cov_method == "radius":
            nn = pool[d2 < p.cov_radius**2]
        else:
            k = min(p.cov_k, len(pool))
            nn = pool[np.argsort(d2)[:k]]
        if len(nn) < 3:
            continue
        c = nn - nn.mean(0)
        C = c.T @ c / len(nn)
        w, V = np.linalg.eigh(C)          # ascending
        lam = np.array([p.cov_eps, 1.0, 1.0])
        covs[i] = V @ np.diag(lam) @ V.T
    return covs


def _estep(src_xyz, src_lab, src_cov, tgt_xyz, tgt_lab, tgt_cov, T, classes, p):
    """§2.2 step 2: per-class NN + soft semantic/geometric weights.

    Returns per-(i,k): target index, weight, combined covariance inverse.
    """
    R = T[:3, :3]
    moved = src_xyz @ R.T + T[:3, 3]
    n, K = len(src_xyz), len(classes)
    idx = np.full((n, K), -1, np.int64)
    w = np.zeros((n, K))
    # rotated source covariances
    RCzRt = np.einsum("ab,nbc,dc->nad", R, src_cov, R)
    sig_inv = np.zeros((n, K, 3, 3))
    lik = np.zeros((n, K))
    for kk, cls in enumerate(classes):
        mask = tgt_lab == cls
        if not mask.any():
            continue
        pool = tgt_xyz[mask]
        pool_idx = np.nonzero(mask)[0]
        d2 = ((moved[:, None, :] - pool[None, :, :]) ** 2).sum(-1)
        j = np.argmin(d2, 1)
        idx[:, kk] = pool_idx[j]
        d = pool[j] - moved
        gate = np.sum(d * d, -1) <= p.max_dist**2
        sigma = tgt_cov[pool_idx[j]] + RCzRt
        s_inv = np.linalg.inv(sigma)
        sig_inv[:, kk] = s_inv
        maha = np.einsum("ni,nij,nj->n", d, s_inv, d)
        det = np.linalg.det(sigma)
        geo = np.exp(-0.5 * maha) / np.sqrt((2 * np.pi) ** 3 * np.maximum(det, 1e-30))
        if p.uniform_semantics:
            sem = 1.0
        else:
            sem = np.where(src_lab == cls, p.alpha, (1 - p.alpha) / max(K - 1, 1))
        lik[:, kk] = sem * geo * gate
    tot = lik.sum(1, keepdims=True)
    nz = tot[:, 0] > 0
    w[nz] = lik[nz] / tot[nz]
    return idx, w, sig_inv


def _mstep(src_xyz, tgt_xyz, idx, w, sig_inv, T0, p):
    """§2.2 step 3: weighted Mahalanobis NLLS over SE(3), GN with LM damping.

    Correspondences, weights and combined covariances are frozen at T0
    within the inner solve (the reference freezes sigma at the E-step
    linearization point [C:med], SURVEY.md §2.2).
    """
    T = T0.copy()
    n, K = w.shape
    lam = p.lm_lambda
    active = w > 0
    ii, kk = np.nonzero(active)
    if len(ii) == 0:
        return T
    z = src_xyz[ii]
    x = tgt_xyz[idx[ii, kk]]
    ww = w[ii, kk]
    Sinv = sig_inv[ii, kk]
    prev_cost = None
    for _ in range(p.gn_iters):
        Rz = z @ T[:3, :3].T + T[:3, 3]
        r = x - Rz                                     # (m,3)
        cost = float(np.einsum("n,ni,nij,nj->", ww, r, Sinv, r))
        # J = d r / d delta with T <- exp(delta) T:  -[I | -(Tz)^]
        J = np.zeros((len(z), 3, 6))
        J[:, :, :3] = -np.eye(3)
        for a in range(len(z)):
            J[a, :, 3:] = _hat(Rz[a])
        H = np.einsum("n,nai,nab,nbj->ij", ww, J, Sinv, J)
        g = np.einsum("n,nai,nab,nb->i", ww, J, Sinv, r)
        delta = np.linalg.solve(H + lam * np.diag(np.diag(H)), -g)
        T = _se3_exp_np(delta) @ T
        if np.linalg.norm(delta) < 1e-9:
            break
        if prev_cost is not None and cost > prev_cost:
            lam *= 10.0
        else:
            lam = max(lam * 0.3, p.lm_lambda)
        prev_cost = cost
    return T


def semantic_icp_np(
    src_xyz, src_lab, tgt_xyz, tgt_lab, p: OracleParams | None = None,
    T_init: np.ndarray | None = None, src_cov=None, tgt_cov=None,
):
    """Full §2.2 EM alignment. Returns (T, info dict)."""
    p = p or OracleParams()
    src_xyz = np.asarray(src_xyz, np.float64)
    tgt_xyz = np.asarray(tgt_xyz, np.float64)
    if src_cov is None:
        src_cov = estimate_covariances_np(src_xyz, src_lab, p)
    if tgt_cov is None:
        tgt_cov = estimate_covariances_np(tgt_xyz, tgt_lab, p)
    classes = np.unique(tgt_lab)
    T = np.eye(4) if T_init is None else np.asarray(T_init, np.float64)
    iters = 0
    for it in range(p.max_iters):
        iters = it + 1
        idx, w, sig_inv = _estep(
            src_xyz, src_lab, src_cov, tgt_xyz, tgt_lab, tgt_cov, T, classes, p
        )
        T_new = _mstep(src_xyz, tgt_xyz, idx, w, sig_inv, T, p)
        step = np.linalg.norm(_se3_log_np(T_new @ np.linalg.inv(T)))
        T = T_new
        if step < p.trans_eps:
            break
    return T, {"iterations": iters, "converged": iters < p.max_iters}
