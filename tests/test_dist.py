"""Distributed tests on the 8-device CPU mesh (SURVEY.md §4.6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semicp import Config
from semicp.cloud import make_cloud, preprocess_cloud
from semicp.data import make_pair, make_scene
from semicp.dist import batched_align, make_mesh
from semicp.dist.batch import shard_batch
from semicp.register import align


def make_cfg():
    return Config().override({
        "cloud.n_pad": 1024, "cloud.num_classes": 6,
        "em.max_iters": 10, "gn.max_iters": 5,
    })


def build_pairs(rng, cfg, n_pairs):
    pairs = []
    for s in range(n_pairs):
        xyz, lab = make_scene(rng, n_points=600, extent=8.0)
        lab = lab - 1
        delta = np.array([0.2, -0.1, 0.03, 0.01, -0.01, 0.02]) * (1 + 0.1 * s)
        src, slab, T_gt = make_pair(rng, xyz, lab, delta, n_classes=6)
        src_c = preprocess_cloud(make_cloud(src, slab, n_pad=cfg.cloud.n_pad), cfg.cov)
        tgt_c = preprocess_cloud(make_cloud(xyz, lab, n_pad=cfg.cloud.n_pad), cfg.cov)
        pairs.append((src_c, tgt_c, T_gt))
    return pairs


def test_mesh_construction():
    mesh = make_mesh({"pairs": 8})
    assert mesh.shape == {"pairs": 8}
    mesh2 = make_mesh({"dp": 2, "blocks": -1})
    assert mesh2.shape == {"dp": 2, "blocks": 4}
    with pytest.raises(ValueError):
        make_mesh({"pairs": 3})


def test_batched_align_matches_single(rng):
    """DP-sharded batched alignment == per-pair single-device alignment."""
    cfg = make_cfg()
    n = 8
    pairs = build_pairs(rng, cfg, n)
    mesh = make_mesh({"pairs": n})

    src_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tgt_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in pairs])
    T0_b = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 4, 4))
    src_b, tgt_b, T0_b = (shard_batch(mesh, x) for x in (src_b, tgt_b, T0_b))

    res_b = batched_align(mesh, cfg)(src_b, tgt_b, T0_b)
    Tb = np.asarray(res_b.T)
    assert Tb.shape == (n, 4, 4)

    for i, (src_c, tgt_c, T_gt) in enumerate(pairs):
        res_i = align(src_c, tgt_c, cfg)
        np.testing.assert_allclose(Tb[i], np.asarray(res_i.T), atol=1e-5)
        # and the batch recovers ground truth
        err = Tb[i].astype(np.float64) @ np.linalg.inv(T_gt.astype(np.float64))
        assert np.linalg.norm(err[:3, 3]) < 0.05


def test_batched_align_sparse_engine_matches_single(rng):
    """The sparse walk's kernel under vmap + shard_map (run_batch's
    product path on a card; interpret mode here) == per-pair align."""
    cfg = make_cfg().override({"corr.engine": "sparse"})
    n = 2
    pairs = build_pairs(rng, cfg, n)
    mesh = make_mesh({"pairs": n}, devices=jax.devices()[:n])
    src_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tgt_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[1] for p in pairs])
    T0_b = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 4, 4))
    src_b, tgt_b, T0_b = (shard_batch(mesh, x) for x in (src_b, tgt_b, T0_b))
    Tb = np.asarray(batched_align(mesh, cfg)(src_b, tgt_b, T0_b).T)
    for i, (src_c, tgt_c, _) in enumerate(pairs):
        np.testing.assert_allclose(Tb[i], np.asarray(align(src_c, tgt_c, cfg).T),
                                   atol=1e-5)
