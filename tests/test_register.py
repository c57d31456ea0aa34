"""Registration golden tests + oracle parity (SURVEY.md §4.3, §4.7)."""

import numpy as np
import jax.numpy as jnp
import pytest

from semicp import Config
from semicp.cloud import make_cloud, preprocess_cloud
from semicp.data import make_pair, make_scene
from semicp.oracle import OracleParams, semantic_icp_np
from semicp.register import align, align_gicp


def pose_errors(T, T_ref):
    err = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_ref, np.float64))
    terr = np.linalg.norm(err[:3, 3])
    rerr = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
    return terr, rerr


def make_test_cfg(n_pad=2048, num_classes=6, **kw):
    over = {"cloud.num_classes": num_classes, "cloud.n_pad": n_pad}
    over.update(kw)
    return Config().override(over)


@pytest.fixture
def pair(rng):
    xyz, lab = make_scene(rng, n_points=1200)
    lab = lab - 1
    delta = np.array([0.3, -0.15, 0.05, 0.02, -0.01, 0.04])
    src, slab, T_gt = make_pair(rng, xyz, lab, delta, noise=0.01, dropout=0.2, n_classes=6)
    return src, slab, xyz, lab, T_gt


def prep(cfg, xyz, lab):
    return preprocess_cloud(make_cloud(xyz, lab, n_pad=cfg.cloud.n_pad), cfg.cov)


def test_align_recovers_gt(pair):
    src, slab, tgt, tlab, T_gt = pair
    cfg = make_test_cfg()
    res = align(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    assert bool(res.converged)
    terr, rerr = pose_errors(res.T, T_gt)
    assert terr < 0.02 and rerr < 0.005, (terr, rerr)


def test_align_parity_with_oracle_radius(pair):
    """Like-for-like radius-covariance parity: a FIXED radius on both
    sides (radius=0 means density-adaptive, which the
    oracle does not model — passing it through made the oracle compute
    all-identity covariances and the old test vacuous)."""
    src, slab, tgt, tlab, T_gt = pair
    radius = 0.6
    cfg = make_test_cfg(**{"cov.radius": radius})
    res = align(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    p = OracleParams(cov_method="radius", cov_radius=radius)
    from semicp.oracle import estimate_covariances_np

    tgt_cov = estimate_covariances_np(tgt.astype(np.float64), tlab, p)
    # guard against the degenerate all-identity oracle covariances
    assert np.abs(tgt_cov - np.eye(3)).max() > 0.3
    T_o, info = semantic_icp_np(src, slab, tgt, tlab, p)
    assert info["converged"]
    terr, rerr = pose_errors(res.T, T_o)
    assert terr < 5e-3 and rerr < 2e-3, (terr, rerr)


def test_align_parity_with_oracle_knn(pair):
    """Reference-semantics anchor: kNN covariances on both sides
    (the reference's k~20 FLANN neighborhoods, SURVEY.md §2.2 step 1)."""
    src, slab, tgt, tlab, T_gt = pair
    cfg = make_test_cfg(**{"cov.method": "knn"})
    res = align(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    T_o, info = semantic_icp_np(
        src, slab, tgt, tlab, OracleParams(cov_method="knn", cov_k=cfg.cov.k))
    assert info["converged"]
    terr, rerr = pose_errors(res.T, T_o)
    assert terr < 5e-3 and rerr < 2e-3, (terr, rerr)


def test_align_from_larger_offset(rng):
    xyz, lab = make_scene(rng, n_points=1500)
    lab = lab - 1
    delta = np.array([1.0, 0.5, 0.1, 0.05, 0.05, 0.15])
    src, slab, T_gt = make_pair(rng, xyz, lab, delta, noise=0.02, dropout=0.1, n_classes=6)
    cfg = make_test_cfg(**{"em.max_iters": 40})
    res = align(prep(cfg, src, slab), prep(cfg, tgt := xyz, lab), cfg)
    terr, rerr = pose_errors(res.T, T_gt)
    assert terr < 0.05 and rerr < 0.01, (terr, rerr)


def test_padding_invariance(pair):
    """Same data, different padding capacity => same answer (mask correctness)."""
    src, slab, tgt, tlab, T_gt = pair
    cfg_a = make_test_cfg(n_pad=2048)
    cfg_b = make_test_cfg(n_pad=4096)
    res_a = align(prep(cfg_a, src, slab), prep(cfg_a, tgt, tlab), cfg_a)
    res_b = align(prep(cfg_b, src, slab), prep(cfg_b, tgt, tlab), cfg_b)
    terr, rerr = pose_errors(res_a.T, res_b.T)
    # 5e-5 not 1e-5: the GN/EM early exits make trip counts data-
    # dependent, so a different padding (different reduction order) can
    # take one extra LM step near the step_eps boundary — a ~1e-5
    # effect. A genuine mask bug shows up at 1e-2+.
    assert terr < 5e-5 and rerr < 5e-5, (terr, rerr)


def corridor_scene(rng, n):
    """Ground + two walls, all parallel to x: translation-invariant along
    x, so the ONLY x information is the semantic label boundary at x=0.
    Labels encode surface type AND side of x=0 (6 classes)."""
    g = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n),
                  rng.normal(n) * 0 + rng.normal(size=n) * 0.01], -1)
    w1 = np.stack([rng.uniform(-10, 10, n // 2), np.full(n // 2, -4.0)
                   + rng.normal(size=n // 2) * 0.01, rng.uniform(0, 3, n // 2)], -1)
    w2 = np.stack([rng.uniform(-10, 10, n // 2), np.full(n // 2, 4.0)
                   + rng.normal(size=n // 2) * 0.01, rng.uniform(0, 3, n // 2)], -1)
    xyz = np.concatenate([g, w1, w2]).astype(np.float32)
    surf = np.concatenate([np.zeros(n), np.ones(n // 2), np.full(n // 2, 2)])
    lab = (surf * 2 + (xyz[:, 0] > 0)).astype(np.int32)
    return xyz, lab


def test_semantics_disambiguate_corridor(rng):
    """The paper's core claim (SURVEY.md §4.3): semantics resolve what
    geometry cannot. Semantic EM-ICP recovers the corridor's x offset;
    uniform-weight EM-ICP cannot observe it."""
    tgt, tlab = corridor_scene(rng, 1200)
    delta = np.array([0.6, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    src, slab, T_gt = make_pair(rng, tgt, tlab, delta, noise=0.01, dropout=0.2, n_classes=6)

    cfg = make_test_cfg(n_pad=4096, num_classes=6, **{"em.alpha": 0.95, "em.max_iters": 50})
    res_sem = align(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    res_uni = align_gicp(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    terr_s, _ = pose_errors(res_sem.T, T_gt)
    terr_u, _ = pose_errors(res_uni.T, T_gt)
    # semantic recovers most of the 0.6 m offset; uniform has no x signal
    assert terr_s < 0.15, (terr_s, terr_u)
    assert terr_u > 2 * terr_s, (terr_s, terr_u)


def test_semantic_robust_to_label_corruption(rng):
    """SURVEY.md §4.3's OTHER half of the paper's claim (VERDICT r4
    missing #3, previously unpinned): semantic weighting still beats
    uniform weighting when a third of the SOURCE labels are corrupted —
    the confusion-matrix alpha model absorbs label noise while the
    surviving consistent labels keep supplying the x signal geometry
    lacks. scripts/ablation_bench.py sweeps the full corruption curve."""
    tgt, tlab = corridor_scene(rng, 1200)
    delta = np.array([0.6, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    src, slab, T_gt = make_pair(rng, tgt, tlab, delta, noise=0.01,
                                dropout=0.2, n_classes=6, label_flip=0.35)
    assert slab.min() >= 0 and slab.max() < 6  # flips stay 0-indexed

    cfg = make_test_cfg(n_pad=4096, num_classes=6,
                        **{"em.alpha": 0.9, "em.max_iters": 50})
    res_sem = align(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    res_uni = align_gicp(prep(cfg, src, slab), prep(cfg, tgt, tlab), cfg)
    terr_s, _ = pose_errors(res_sem.T, T_gt)
    terr_u, _ = pose_errors(res_uni.T, T_gt)
    assert terr_s < 0.2, (terr_s, terr_u)
    assert terr_u > 2 * terr_s, (terr_s, terr_u)


def test_identity_pair_stays_identity(rng):
    xyz, lab = make_scene(rng, n_points=800)
    lab = lab - 1
    cfg = make_test_cfg(n_pad=1024)
    c = prep(cfg, xyz, lab)
    res = align(c, c, cfg)
    T = np.asarray(res.T)
    np.testing.assert_allclose(T, np.eye(4), atol=5e-4)
