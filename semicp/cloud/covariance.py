"""GICP plane-to-plane per-point covariance estimation — planar, one pass.

Reference counterpart: covariance construction inside SemanticPointCloud
(k~20 FLANN kNN per point + Eigen::SelfAdjointEigenSolver + eigenvalue
clamp to (1,1,eps); SURVEY.md §2.1 row "Per-point covariance estimation",
§2.2 step 1, §3.4). The reference computes each point's neighborhood
within its own semantic class's sub-cloud; `class_aware=True` reproduces
that.

Two neighbourhoods: method "radius" (the default) sums masked moments
over a radius (cloud/moments.py); method "knn" takes the reference's k
nearest neighbours from the brute-force engine
(semicp.corr.bruteforce.knn_self — tiled distance matmuls + top-k), whose
neighbour coordinates are gathered as (N, k) planes. Both end in the
rank-1 clamp C_reg = I - (1-eps) n n^T (semicp.geom.sym3.regularize_gicp),
amortized across EM iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from semicp.cloud.cloud import Cloud
from semicp.config import CovConfig
from semicp.corr.bruteforce import knn_self
from semicp.geom import sym3


def estimate_covariances(
    cloud: Cloud, cfg: CovConfig, class_aware: bool = True,
    num_classes: int | None = None,
) -> jnp.ndarray:
    """Return (6, N_pad) regularized covariance planes for valid points.

    Points with < 3 valid neighbors get the identity — the branchless
    analogue of the reference's skip. Method selection: see CovConfig.
    `num_classes` enables the sparse moments walk on cm-sorted clouds
    (corr.layout).
    """
    if cfg.method == "radius":
        return _estimate_radius(cloud, cfg, class_aware, num_classes)
    return _estimate_knn(cloud, cfg, class_aware)


def estimate_radius(xyz, label, valid, k: int = 20, class_aware: bool = True,
                    n_samples: int = 256, scale: float = 1.3):
    """Density-adaptive neighborhood radius (traced scalar, jit-safe).

    The reference's kNN covariance adapts to point density by construction;
    a fixed radius does not (sparse clouds -> empty neighborhoods ->
    identity covariances -> degraded GICP). This estimates the k-th-NN
    distance on a strided sample of points (same-class, like the
    reference's per-label sub-cloud search) and returns its median times
    `scale`, so radius neighborhoods hold ~k+ points at any density.
    """
    n = xyz.shape[1]
    s = min(n_samples, n)
    # Stride over the VALID prefix (make_cloud packs points at the front),
    # not over n_pad: the sampled query set — and hence the estimated
    # radius — must be identical across padding capacities
    # (test_padding_invariance). Invalid samples are masked to NaN below.
    cnt = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    idx = (jnp.arange(s) * cnt) // s                     # (S,) in [0, cnt)
    q = xyz[:, idx]                                      # (3, S)
    qlab, qval = label[idx], valid[idx]
    d2 = (jnp.sum(q * q, 0)[:, None] + jnp.sum(xyz * xyz, 0)[None, :]
          - 2.0 * (q.T @ xyz))                           # (S, N)
    mask = valid[None, :]
    if class_aware:
        mask = mask & (qlab[:, None] == label[None, :])
    d2 = jnp.where(mask, jnp.maximum(d2, 0.0), jnp.inf)
    kk = min(k + 1, n)                                   # +1: self-match
    kth = -jax.lax.top_k(-d2, kk)[0][:, -1]
    kth = jnp.where(qval & jnp.isfinite(kth), kth, jnp.nan)
    r = jnp.sqrt(jnp.nanmedian(kth))
    return scale * jnp.where(jnp.isnan(r), 1.0, r)


def _estimate_radius(cloud: Cloud, cfg: CovConfig, class_aware: bool,
                     num_classes: int | None = None) -> jnp.ndarray:
    from semicp.cloud.moments import neighborhood_moments

    label = jnp.maximum(cloud.label, 0) if class_aware else jnp.zeros_like(cloud.label)
    if cfg.radius > 0:
        radius = cfg.radius
    else:  # radius=0 -> auto: match the reference's k-NN density adaptivity
        radius = estimate_radius(cloud.xyz, label, cloud.valid,
                                 k=cfg.k, class_aware=class_aware)
    mom = neighborhood_moments(
        cloud.xyz, label, cloud.valid, radius,
        num_classes=num_classes,
        layout=cloud.layout if class_aware else "raw",
    )
    cnt = mom[0]
    safe = jnp.maximum(cnt, 1.0)
    mx, my, mz = mom[1] / safe, mom[2] / safe, mom[3] / safe
    cov = (
        mom[4] / safe - mx * mx,
        mom[5] / safe - my * my,
        mom[6] / safe - mz * mz,
        mom[7] / safe - mx * my,
        mom[8] / safe - mx * mz,
        mom[9] / safe - my * mz,
    )
    reg = sym3.regularize_gicp(cov, cfg.eps)
    enough = (cnt >= 3.0) & cloud.valid
    eye = sym3.identity_like(cov[0])
    out = tuple(jnp.where(enough, r, e) for r, e in zip(reg, eye))
    return sym3.pack(out)


def _estimate_knn(cloud: Cloud, cfg: CovConfig, class_aware: bool) -> jnp.ndarray:
    idx, _d2, nvalid = knn_self(
        cloud.xyz, jnp.maximum(cloud.label, 0), cloud.valid, k=cfg.k,
        class_aware=class_aware,
    )
    w = nvalid.astype(jnp.float32)                   # (N, k)
    cnt = jnp.sum(w, -1)                             # (N,)
    safe = jnp.maximum(cnt, 1.0)

    # Planar neighbor gathers: (N, k) per coordinate
    nx = jnp.take(cloud.xyz[0], idx)
    ny = jnp.take(cloud.xyz[1], idx)
    nz = jnp.take(cloud.xyz[2], idx)
    mx = jnp.sum(nx * w, -1) / safe
    my = jnp.sum(ny * w, -1) / safe
    mz = jnp.sum(nz * w, -1) / safe
    cx = (nx - mx[:, None]) * w
    cy = (ny - my[:, None]) * w
    cz = (nz - mz[:, None]) * w
    # empirical covariance components; w in {0,1} so w^2 == w
    cov = (
        jnp.sum(cx * cx, -1) / safe,
        jnp.sum(cy * cy, -1) / safe,
        jnp.sum(cz * cz, -1) / safe,
        jnp.sum(cx * cy, -1) / safe,
        jnp.sum(cx * cz, -1) / safe,
        jnp.sum(cy * cz, -1) / safe,
    )
    reg = sym3.regularize_gicp(cov, cfg.eps)
    enough = (cnt >= 3.0) & cloud.valid
    eye = sym3.identity_like(cov[0])
    out = tuple(jnp.where(enough, r, e) for r, e in zip(reg, eye))
    return sym3.pack(out)


def preprocess_cloud(cloud: Cloud, cfg, class_aware: bool = True) -> Cloud:
    """Fill `cloud.cov6` with GICP-regularized covariances (jit-able).

    With a full `Config`, the cloud is first put in canonical
    class-major Morton layout (corr.layout.sort_cloud_cm) — ONE sort
    shared by the sparse moments walk here and the block-sparse NN
    inside align (which then skips its own sorts). With a bare
    `CovConfig`, layout is left untouched and the dense sweep runs.
    """
    num_classes = None
    if hasattr(cfg, "cov"):                  # full Config
        from semicp.corr.layout import sort_cloud_cm

        if cloud.layout != "cm":
            cloud = sort_cloud_cm(cloud, cfg.cloud.num_classes, cfg.corr.cell)
        num_classes = cfg.cloud.num_classes
        cfg = cfg.cov
    return cloud.replace(cov6=estimate_covariances(cloud, cfg, class_aware,
                                                   num_classes=num_classes))
