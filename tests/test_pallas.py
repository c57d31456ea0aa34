"""Block-sparse NN and E-step reduce against their plain references
(SURVEY.md §4.2).

On the CPU backend the sparse walk's Pallas kernel runs in interpret
mode, so these tests pin the kernel's *semantics*; the tests marked
`gpu` compile the same kernel for the card and compare it with the
brute-force reference there (SEMICP_GPU_TESTS=1 pytest -m gpu).
Tolerances: targets lie within +-60 m, where the brute force's expanded
d2 = |q|^2 + |t|^2 - 2 q.t loses up to |x|^2 * 2^-23 ~ 1e-3 m^2 to f32
cancellation (corr/bruteforce.py); the walk subtracts coordinates
directly, so d2 agrees to atol 1e-3 and the winners are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semicp.cloud.cloud import Cloud
from semicp.corr.sparse_nn import (
    INF,
    class_nn_attrs_sparse,
    class_nn_attrs_xla,
    pack_sparse,
    prepare_sparse,
)
from semicp.register.estep import estep_reduce, estep_weights


def _cloud(xyz, lab, cov6, val):
    return Cloud(xyz=xyz, label=lab, cov6=cov6, valid=val,
                 count=jnp.sum(val.astype(jnp.int32)))


def random_target(rng, N, K, extent, n_present=None):
    xyz = jnp.asarray(rng.normal(size=(3, N)).astype(np.float32) * extent)
    lab = jnp.asarray(rng.integers(0, n_present or K, size=N).astype(np.int32))
    val = jnp.asarray(rng.uniform(size=N) > 0.1)
    cov6 = jnp.asarray(rng.normal(size=(6, N)).astype(np.float32))
    return xyz, lab, val, cov6


def check_sparse_matches_xla_within_gate(rng, N, K, gate, extent=15.0,
                                         n_present=None, q_shift=0.0,
                                         qb=64, tb=128):
    """Exactness contract: for every (query, class) whose true per-class
    NN lies within `gate`, the sparse walk returns the brute-force
    answer; beyond the gate an entry is INF or a real, never closer,
    target point. Returns the number of (class, query) pairs inside."""
    xyz, lab, val, cov6 = random_target(rng, N, K, extent, n_present)
    q = jnp.asarray(rng.normal(size=(3, N)).astype(np.float32) * extent
                    + q_shift)
    qval = jnp.ones(N, bool)

    d2_x, at_x = class_nn_attrs_xla(xyz, lab, val, cov6, q, K)
    prep = prepare_sparse(_cloud(xyz, lab, cov6, val), K, cell=1.0, tb=tb)
    d2_s, at_s = class_nn_attrs_sparse(prep, q, qval, num_classes=K,
                                       gate=gate, qb=qb)
    d2_x, at_x, d2_s, at_s = map(np.asarray, (d2_x, at_x, d2_s, at_s))
    assert d2_s.shape == (K, N) and at_s.shape == (K, 16, N)

    inside = d2_x <= gate * gate * (1.0 - 1e-5)
    np.testing.assert_allclose(d2_s[inside], d2_x[inside], rtol=1e-4, atol=1e-3)
    ax = np.moveaxis(at_x, 1, 0)[:, inside]
    asp = np.moveaxis(at_s, 1, 0)[:, inside]
    np.testing.assert_array_equal(asp, ax)
    outside = ~inside
    assert (d2_s[outside] >= d2_x[outside] * (1 - 1e-4) - 1e-3).all()
    # rows beyond (x, y, z, cov6, found) are zero, as are unfound rows
    assert (at_s[:, 10:] == 0).all()
    assert (np.moveaxis(at_s, 1, 0)[:, d2_s >= INF] == 0).all()
    return int(inside.sum())


def test_class_nn_sparse_matches_xla_within_gate(rng):
    assert check_sparse_matches_xla_within_gate(rng, N=1024, K=5, gate=2.0) > 0


def test_class_nn_sparse_tight_gate_prunes(rng):
    """A tight gate must still be exact inside and prune most tiles."""
    assert check_sparse_matches_xla_within_gate(rng, N=1024, K=3, gate=0.5) > 0


@pytest.mark.parametrize("case", [
    dict(N=512, K=1, gate=2.0),                        # one class
    dict(N=1024, K=20, gate=2.0, extent=6.0),          # the bench's K
    dict(N=1024, K=6, gate=2.0, n_present=3),          # missing classes
    dict(N=1024, K=4, gate=0.25),                      # tight gate
    dict(N=1024, K=4, gate=50.0),                      # gate wider than the cloud
    dict(N=1024, K=4, gate=1.0, qb=32, tb=64),         # small tiles
    dict(N=1024, K=4, gate=1.0, qb=128, tb=256),       # large tiles
])
def test_sparse_walk_matches_bruteforce(rng, case):
    check_sparse_matches_xla_within_gate(rng, **case)


def test_sparse_walk_empty_candidate_lists(rng):
    """Queries far outside the target's tiles have no candidates: every
    class comes back INF with zero attributes."""
    N, K = 512, 3
    xyz, lab, val, cov6 = random_target(rng, N, K, 5.0)
    q = jnp.asarray(rng.normal(size=(3, N)).astype(np.float32) + 1000.0)
    prep = prepare_sparse(_cloud(xyz, lab, cov6, val), K, cell=1.0)
    d2, at = map(np.asarray, class_nn_attrs_sparse(
        prep, q, jnp.ones(N, bool), num_classes=K, gate=2.0))
    assert (d2 >= INF).all() and (at == 0).all()


def test_sparse_walk_class_missing(rng):
    """A class absent from the target must come back d2 == INF, attrs 0,
    while present classes are found everywhere under a wide gate."""
    N, K = 512, 4
    xyz, lab, val, cov6 = random_target(rng, N, K, 3.0, n_present=2)
    val = jnp.ones(N, bool)
    prep = prepare_sparse(_cloud(xyz, lab, cov6, val), K, cell=1.0)
    d2, at = map(np.asarray, class_nn_attrs_sparse(
        prep, xyz, val, num_classes=K, gate=100.0))
    assert (d2[2:] >= INF).all() and (at[2:] == 0).all()
    assert (d2[:2] < INF).all() and (at[:2, 9] == 1.0).all()


def test_class_nn_sparse_shape_contract(rng):
    """Non-tile-multiple inputs fail loudly, not with a reshape error."""
    xyz = jnp.asarray(rng.normal(size=(3, 768)).astype(np.float32))
    lab = jnp.zeros(768, jnp.int32)
    val = jnp.ones(768, bool)
    cov6 = jnp.zeros((6, 768), jnp.float32)
    with pytest.raises(ValueError, match="multiple"):
        prepare_sparse(_cloud(xyz, lab, cov6, val), 4, cell=1.0, tb=512)


def test_sparse_walk_query_padding_error(rng):
    xyz, lab, val, cov6 = random_target(rng, 512, 3, 5.0)
    prep = pack_sparse(xyz, lab, val, cov6, 3)
    q = jnp.zeros((3, 96), jnp.float32)
    with pytest.raises(ValueError, match="multiple of the query tile"):
        class_nn_attrs_sparse(prep, q, jnp.ones(96, bool), num_classes=3,
                              gate=2.0, qb=64)


def test_pack_sparse_layout(rng):
    """The packed slab's rows and the tile metadata of a cm-sorted cloud."""
    from semicp.corr.layout import sort_cloud_cm

    N, K = 512, 4
    xyz, lab, val, cov6 = random_target(rng, N, K, 5.0)
    c = sort_cloud_cm(_cloud(xyz, lab, cov6, val), K, 1.0)
    p = pack_sparse(c.xyz, c.label, c.valid, c.cov6, K, tb=128)
    a = np.asarray(p["attrs16"])
    np.testing.assert_array_equal(a[:3], np.asarray(c.xyz))
    np.testing.assert_allclose(a[10], (np.asarray(c.xyz) ** 2).sum(0), rtol=1e-6)
    lab_s = np.where(np.asarray(c.valid), np.asarray(c.label), K)
    np.testing.assert_array_equal(a[11], lab_s)
    assert p["lo"].shape == (N // 128, 3) and p["cmin"].shape == (N // 128,)
    # class-major: each tile's labels are the contiguous range [cmin, cmax]
    tiles = lab_s.reshape(-1, 128)
    for t, lo, hi in zip(tiles, np.asarray(p["cmin"]), np.asarray(p["cmax"])):
        real = t[t < K]
        if real.size:
            assert real.min() == lo and real.max() == hi


def test_tile_candidates_compaction(rng):
    """Candidate lists hold exactly the in-gate tiles, ascending."""
    from semicp.corr.layout import tile_candidates
    from semicp.corr.morton import box_dist2

    qlo = rng.uniform(-10, 10, size=(16, 3)).astype(np.float32)
    tlo = rng.uniform(-10, 10, size=(32, 3)).astype(np.float32)
    qhi, thi = qlo + 1.0, tlo + 1.0
    gate = 3.0
    cand, count = map(np.asarray, tile_candidates(
        jnp.asarray(qlo), jnp.asarray(qhi), jnp.asarray(tlo),
        jnp.asarray(thi), gate))
    bd2 = np.asarray(box_dist2(jnp.asarray(qlo), jnp.asarray(qhi),
                               jnp.asarray(tlo), jnp.asarray(thi)))
    for i in range(16):
        want = np.nonzero(bd2[i] <= gate * gate * (1 + 1e-5) + 1e-6)[0]
        np.testing.assert_array_equal(cand[i, :count[i]], want)


@pytest.mark.gpu
def test_sparse_walk_compiled_matches_bruteforce(gpu, rng):
    """The kernel compiled for the card (not interpreted) against the
    brute-force reference, at a width where every tile has candidates."""
    with jax.default_device(gpu):
        check_sparse_matches_xla_within_gate(rng, N=16384, K=20, gate=2.0,
                                             extent=20.0)


def make_estep_fixture(rng, K=6, N=1024, gate=2.0):
    """Random NN-search-shaped inputs with SPD combined covariances."""
    spd = rng.normal(size=(N, 3, 3))
    spd = spd @ np.swapaxes(spd, -1, -2) + np.eye(3) * 0.5
    rc = np.stack([spd[:, 0, 0], spd[:, 1, 1], spd[:, 2, 2],
                   spd[:, 0, 1], spd[:, 0, 2], spd[:, 1, 2]]).astype(np.float32)
    spd2 = rng.normal(size=(K, N, 3, 3))
    spd2 = spd2 @ np.swapaxes(spd2, -1, -2) + np.eye(3) * 0.3
    cx = np.stack([spd2[..., 0, 0], spd2[..., 1, 1], spd2[..., 2, 2],
                   spd2[..., 0, 1], spd2[..., 0, 2], spd2[..., 1, 2]], 1
                  ).astype(np.float32)                     # (K,6,N)
    moved = (rng.normal(size=(3, N)) * 3).astype(np.float32)
    x = moved[None] + rng.normal(size=(K, 3, N)).astype(np.float32)
    attrs = np.concatenate([x, cx, np.zeros((K, 7, N), np.float32)], 1)
    nn_d2 = np.sum((x - moved[None]) ** 2, 1).astype(np.float32)
    nn_d2[rng.uniform(size=(K, N)) < 0.15] = 3.0e37        # missing classes
    log_sem = (rng.normal(size=(K, N)) * 0.5).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return (jnp.asarray(nn_d2), jnp.asarray(attrs), jnp.asarray(rc),
            jnp.asarray(moved), jnp.asarray(log_sem), jnp.asarray(valid))


def test_estep_reduce_matches_weights_reference(rng):
    """The reduce contract must equal explicit (K,N) weight reductions."""
    gate2 = 4.0
    nn_d2, attrs, rc, moved, log_sem, valid = make_estep_fixture(rng)
    a, b, c, wsum = estep_reduce(nn_d2, attrs, rc, moved,
                                 log_sem, valid, gate2)
    # rebuild from first principles
    K, _, N = attrs.shape
    x = np.asarray(attrs[:, :3])                           # (K,3,N)
    sigma = np.asarray(attrs[:, 3:9]) + np.asarray(rc)[None]
    d = x - np.asarray(moved)[None]
    exact_d2 = np.sum(d * d, 1)
    gate = ((exact_d2 <= gate2) & (np.asarray(nn_d2) < 1e37)
            & np.asarray(valid)[None]).astype(np.float32)
    w, sinv = estep_weights(jnp.asarray(np.moveaxis(sigma, 1, 0)),
                            jnp.asarray(np.moveaxis(d, 1, 0)),
                            log_sem, jnp.asarray(gate))
    w, sinv = np.asarray(w), np.asarray(sinv)              # (K,N), (6,K,N)
    np.testing.assert_allclose(np.asarray(wsum), w.sum(0), atol=1e-5)
    a_ref = np.einsum("kn,skn->sn", w, sinv)
    np.testing.assert_allclose(np.asarray(a), a_ref, rtol=1e-4, atol=1e-4)
    xs = np.asarray(attrs[:, :3])
    t = np.stack([sinv[0] * xs[:, 0] + sinv[3] * xs[:, 1] + sinv[4] * xs[:, 2],
                  sinv[3] * xs[:, 0] + sinv[1] * xs[:, 1] + sinv[5] * xs[:, 2],
                  sinv[4] * xs[:, 0] + sinv[5] * xs[:, 1] + sinv[2] * xs[:, 2]])
    np.testing.assert_allclose(np.asarray(b), np.einsum("kn,skn->sn", w, t),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(c), np.einsum("kn,skn,skn->n", w, xs.transpose(1, 0, 2), t),
        rtol=1e-4, atol=1e-2)
    # weights are a proper distribution where any class is gated in
    tot = w.sum(0)
    assert ((np.abs(tot - 1.0) < 1e-5) | (tot == 0.0)).all()
