"""Covariance preprocessing vs the numpy oracle (SURVEY.md §4.2, §3.4)."""

import numpy as np
import pytest

from semicp.cloud import make_cloud, preprocess_cloud
from semicp.config import CovConfig
from semicp.data import make_scene
from semicp.geom import sym3
from semicp.oracle import OracleParams, estimate_covariances_np


def cov_matrices(cloud, n):
    """Planar (6, N) covariance storage -> (n, 3, 3) numpy matrices."""
    return np.asarray(sym3.to_matrix(tuple(cloud.cov6)))[:n]


def test_sparse_moment_covariances_match_dense(rng):
    """Sparse moments walk (cm layout) == dense XLA moments through the
    covariance epilogue. Moments are compared at the COVARIANCE level
    because the walk centres per query tile (documented contract)."""
    import jax.numpy as jnp

    from semicp.cloud.moments import (
        neighborhood_moments_sparse, neighborhood_moments_xla,
    )
    from semicp.corr.layout import sort_cloud_cm

    N, K = 1024, 5
    xyz, lab = make_scene(rng, n_points=900, extent=8.0, n_classes=K)
    c = sort_cloud_cm(make_cloud(xyz, lab - 1, n_pad=N), K, cell=1.0)
    label = jnp.maximum(c.label, 0)
    r = 0.9
    m_x = np.asarray(neighborhood_moments_xla(c.xyz, label, c.valid, r))
    m_s = np.asarray(neighborhood_moments_sparse(
        c.xyz, label, c.valid, r, num_classes=K, qb=256, tb=256))

    def to_cov(m):
        cnt = np.maximum(m[0], 1.0)
        mx, my, mz = m[1] / cnt, m[2] / cnt, m[3] / cnt
        return np.stack([
            m[4] / cnt - mx * mx, m[5] / cnt - my * my, m[6] / cnt - mz * mz,
            m[7] / cnt - mx * my, m[8] / cnt - mx * mz, m[9] / cnt - my * mz,
        ])

    np.testing.assert_allclose(m_s[0], m_x[0], atol=0.5)   # counts
    valid = np.asarray(c.valid) & (m_x[0] >= 3)
    np.testing.assert_allclose(to_cov(m_s)[:, valid], to_cov(m_x)[:, valid],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_sparse_moments_compiled_match_dense(gpu, rng):
    """The moments walk compiled for the card against the dense sweep at
    a width where query tiles have several candidates."""
    import jax
    import jax.numpy as jnp

    from semicp.cloud.moments import (
        neighborhood_moments_sparse, neighborhood_moments_xla,
    )
    from semicp.corr.layout import sort_cloud_cm

    N, K = 16384, 8
    xyz, lab = make_scene(rng, n_points=15000, extent=20.0, n_classes=K)
    with jax.default_device(gpu):
        c = sort_cloud_cm(make_cloud(xyz, lab - 1, n_pad=N), K, cell=2.0)
        label = jnp.maximum(c.label, 0)
        m_x = np.asarray(neighborhood_moments_xla(c.xyz, label, c.valid, 0.8))
        m_s = np.asarray(neighborhood_moments_sparse(
            c.xyz, label, c.valid, 0.8, num_classes=K))
    valid = np.asarray(c.valid)
    np.testing.assert_array_equal(m_s[0][valid], m_x[0][valid])


def test_preprocess_full_config_sorts_and_matches_legacy(rng):
    """preprocess_cloud(cloud, full Config) returns a cm-sorted cloud whose
    per-point covariances match the legacy (unsorted, dense) path."""
    from semicp.config import Config

    xyz, lab = make_scene(rng, n_points=900, extent=8.0, n_classes=5)
    lab = lab - 1
    cfg = Config().override({"cloud.n_pad": 1024, "cloud.num_classes": 5,
                             "cov.radius": 0.9})
    c_new = preprocess_cloud(make_cloud(xyz, lab, n_pad=1024), cfg)
    assert c_new.layout == "cm"
    c_old = preprocess_cloud(make_cloud(xyz, lab, n_pad=1024), cfg.cov)
    # match rows by point identity (sorted vs unsorted order)
    new_pts = np.asarray(c_new.xyz).T[np.asarray(c_new.valid)]
    new_cov = np.asarray(c_new.cov6).T[np.asarray(c_new.valid)]
    old_pts = np.asarray(c_old.xyz).T[np.asarray(c_old.valid)]
    old_cov = np.asarray(c_old.cov6).T[np.asarray(c_old.valid)]
    order_n = np.lexsort(new_pts.T)
    order_o = np.lexsort(old_pts.T)
    np.testing.assert_array_equal(new_pts[order_n], old_pts[order_o])
    # the legacy path accumulates UNCENTERED f32 moments, so its S2/n -
    # mean^2 epilogue carries summation-order-dependent cancellation
    # noise (~0.1 abs on a handful of near-degenerate neighborhoods);
    # the sorted path sums the same values in a different order. The
    # sparse walk centres per tile and does not have this issue.
    np.testing.assert_allclose(new_cov[order_n], old_cov[order_o],
                               rtol=2e-3, atol=0.2)
    close = np.isclose(new_cov[order_n], old_cov[order_o], rtol=2e-3, atol=2e-3)
    assert close.mean() > 0.995


def test_radius_covariance_planar_normals(rng):
    """Radius-moment covariances recover plane normals like kNN does."""
    plane = np.concatenate(
        [rng.uniform(-8, 8, size=(2000, 2)), rng.normal(size=(2000, 1)) * 0.01], -1
    ).astype(np.float32)
    c = make_cloud(plane, np.zeros(2000, np.int32), n_pad=2048)
    c = preprocess_cloud(c, CovConfig(method="radius", radius=0.8))
    covs = cov_matrices(c, 2000).astype(np.float64)
    w, V = np.linalg.eigh(covs)
    np.testing.assert_allclose(w[:, 0], 1e-3, rtol=1e-2)
    assert np.mean(np.abs(V[:, 2, 0])) > 0.99


def test_planar_normals(rng):
    plane = np.concatenate(
        [rng.uniform(-8, 8, size=(2000, 2)), rng.normal(size=(2000, 1)) * 0.01], -1
    ).astype(np.float32)
    c = make_cloud(plane, np.zeros(2000, np.int32), n_pad=2048)
    c = preprocess_cloud(c, CovConfig())
    covs = cov_matrices(c, 2000).astype(np.float64)
    w, V = np.linalg.eigh(covs)
    # smallest eigenvalue clamped to eps, its eigvec ~ +-z
    np.testing.assert_allclose(w[:, 0], 1e-3, rtol=1e-2)
    assert np.mean(np.abs(V[:, 2, 0])) > 0.99


def test_matches_oracle_covariances(rng):
    xyz, lab = make_scene(rng, n_points=2000, extent=10.0)
    lab = lab - 1
    c = make_cloud(xyz, lab, n_pad=2048)
    cfg = CovConfig(method="knn", k=20)
    c = preprocess_cloud(c, cfg)
    got = cov_matrices(c, 2000).astype(np.float64)
    ref = estimate_covariances_np(
        xyz.astype(np.float64), lab, OracleParams(cov_k=20)
    )
    # Compare the clamped covariance matrices; the hash-grid kNN may pick a
    # slightly different neighbor set when neighbors span > cell radius, so
    # compare where the oracle's 20th neighbor is within the probe radius.
    ok = 0
    for i in range(2000):
        pool = xyz[lab == lab[i]]
        d2 = np.sort(np.sum((pool - xyz[i]) ** 2, -1))
        if len(d2) >= 20 and d2[19] < 1.5**2:
            np.testing.assert_allclose(got[i], ref[i], atol=0.05)
            ok += 1
    assert ok > 100  # the comparison actually exercised a decent sample
