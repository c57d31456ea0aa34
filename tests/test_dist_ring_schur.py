"""Ring correspondence + distributed Schur BA on the 8-device CPU mesh
(SURVEY.md §4.6): mesh results must match single-device references."""

import jax
import jax.numpy as jnp
import numpy as np

from semicp.corr.sparse_nn import class_nn_attrs_xla
from semicp.dist import make_mesh
from semicp.dist.ring_corr import make_ring_nn
from semicp.geom.se3 import se3_exp
from semicp.slam.schur import ba_solve_single, make_ba_solver


def test_ring_nn_matches_single(rng):
    D, K = 8, 4
    N = 1024            # total map points (128 per block)
    Q = 512             # total query points
    xyz = jnp.asarray(rng.normal(size=(3, N)).astype(np.float32) * 10)
    lab = jnp.asarray(rng.integers(0, K, size=N).astype(np.int32))
    val = jnp.asarray(rng.uniform(size=N) > 0.1)
    cov6 = jnp.asarray(rng.normal(size=(6, N)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(3, Q)).astype(np.float32) * 10)

    # single-device reference over the whole map
    d2_ref, at_ref = class_nn_attrs_xla(xyz, lab, val, cov6, q, K)

    mesh = make_mesh({"blocks": D})
    ring = make_ring_nn(mesh, num_classes=K)
    d2, at = ring(q, xyz, lab, val, cov6)

    d2, at, d2_ref, at_ref = map(np.asarray, (d2, at, d2_ref, at_ref))
    f = d2_ref < 1e30
    assert (f == (d2 < 1e30)).all()
    np.testing.assert_allclose(d2[f], d2_ref[f], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.moveaxis(at, 1, 0)[:, f],
                               np.moveaxis(at_ref, 1, 0)[:, f], atol=1e-5)


def test_ring_nn_sparse_engine_matches_single_within_gate(rng):
    """The map-scale path — the block-sparse walk inside the ring
    (interpret mode on the CPU mesh) — must equal the
    single-device reference for every correspondence within the gate
    (beyond it the sparse prune may return INF; the E-step rejects
    there anyway). VERDICT r3 Missing #2."""
    D, K, gate = 8, 4, 2.0
    N, Q = 2048, 1024
    xyz = jnp.asarray(rng.normal(size=(3, N)).astype(np.float32) * 8)
    lab = jnp.asarray(rng.integers(0, K, size=N).astype(np.int32))
    val = jnp.asarray(rng.uniform(size=N) > 0.1)
    cov6 = jnp.asarray(rng.normal(size=(6, N)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(3, Q)).astype(np.float32) * 8)

    d2_ref, at_ref = class_nn_attrs_xla(xyz, lab, val, cov6, q, K)

    mesh = make_mesh({"blocks": D})
    ring = make_ring_nn(mesh, num_classes=K, engine="sparse", gate=gate)
    d2, at = ring(q, xyz, lab, val, cov6)

    d2, at, d2_ref, at_ref = map(np.asarray, (d2, at, d2_ref, at_ref))
    inside = d2_ref <= gate * gate * (1.0 - 1e-5)
    assert inside.any()
    np.testing.assert_allclose(d2[inside], d2_ref[inside],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.moveaxis(at, 1, 0)[:, inside],
                               np.moveaxis(at_ref, 1, 0)[:, inside],
                               atol=1e-5)
    # beyond-gate entries may be pruned to INF but never fabricated
    outside = ~inside
    assert (d2[outside] >= d2_ref[outside] * (1 - 1e-4) - 1e-3).all()


def make_ba_problem(rng, M=6, L=512, obs_per_lm=3):
    """Synthetic BA: noisy poses+landmarks observing ground truth."""
    gt_poses = [np.eye(4)]
    for i in range(1, M):
        d = np.array([1.0, 0.1, 0, 0.01, 0, 0.05], np.float32)
        gt_poses.append(gt_poses[-1] @ np.asarray(se3_exp(jnp.asarray(d))))
    gt_poses = np.stack(gt_poses).astype(np.float64)
    gt_lms = rng.uniform(-5, 15, size=(L, 3))

    obs_pose, obs_lm, obs_z = [], [], []
    for l in range(L):
        for i in rng.choice(M, size=obs_per_lm, replace=False):
            Ti = np.linalg.inv(gt_poses[i])
            z = Ti[:3, :3] @ gt_lms[l] + Ti[:3, 3]
            obs_pose.append(i)
            obs_lm.append(l)
            obs_z.append(z + rng.normal(size=3) * 0.01)
    O = len(obs_pose)

    # noisy initialization
    init_poses = gt_poses.copy()
    for i in range(1, M):
        d = rng.normal(size=6) * np.array([0.1, 0.1, 0.05, 0.01, 0.01, 0.02])
        init_poses[i] = init_poses[i] @ np.asarray(
            se3_exp(jnp.asarray(d.astype(np.float32))), np.float64)
    init_lms = gt_lms + rng.normal(size=(L, 3)) * 0.1
    return (gt_poses, gt_lms, init_poses.astype(np.float32),
            init_lms.astype(np.float32),
            np.asarray(obs_pose, np.int32), np.asarray(obs_lm, np.int32),
            np.asarray(obs_z, np.float32), np.ones(O, np.float32))


def test_schur_ba_converges(rng):
    gt_p, gt_l, p0, l0, oi, ol, oz, ow = make_ba_problem(rng)
    poses, lms = ba_solve_single(
        jnp.asarray(p0), jnp.asarray(l0), jnp.asarray(oi), jnp.asarray(ol),
        jnp.asarray(oz), jnp.asarray(ow), iters=6)
    poses = np.asarray(poses, np.float64)
    err_t = np.linalg.norm(poses[:, :3, 3] - gt_p[:, :3, 3], axis=1)
    assert err_t.max() < 0.02, err_t
    lm_err = np.linalg.norm(np.asarray(lms) - gt_l, axis=1)
    assert np.median(lm_err) < 0.02, np.median(lm_err)


def test_schur_ba_mesh_matches_single(rng):
    D = 8
    gt_p, gt_l, p0, l0, oi, ol, oz, ow = make_ba_problem(rng, M=6, L=512, obs_per_lm=3)
    L = l0.shape[0]
    # group observations by landmark shard: landmark l lives on device l // (L//D)
    per = L // D
    order = np.argsort(ol // per, kind="stable")
    oi, ol, oz, ow = oi[order], ol[order], oz[order], ow[order]
    # pad each shard's observation list to the max, with local lm indices
    obs_dev = [np.nonzero((ol // per) == d)[0] for d in range(D)]
    omax = max(len(x) for x in obs_dev)
    OI = np.zeros((D, omax), np.int32)
    OL = np.zeros((D, omax), np.int32)
    OZ = np.zeros((D, omax, 3), np.float32)
    OW = np.zeros((D, omax), np.float32)
    for d, sel in enumerate(obs_dev):
        n = len(sel)
        OI[d, :n] = oi[sel]
        OL[d, :n] = ol[sel] - d * per          # local index within shard
        OZ[d, :n] = oz[sel]
        OW[d, :n] = ow[sel]

    mesh = make_mesh({"blocks": D})
    solver = make_ba_solver(mesh, m=p0.shape[0], iters=6)
    poses_d, lms_d = solver(
        jnp.asarray(p0), jnp.asarray(l0),
        jnp.asarray(OI.reshape(-1)), jnp.asarray(OL.reshape(-1)),
        jnp.asarray(OZ.reshape(-1, 3)), jnp.asarray(OW.reshape(-1)))

    poses_s, lms_s = ba_solve_single(
        jnp.asarray(p0), jnp.asarray(l0), jnp.asarray(oi), jnp.asarray(ol),
        jnp.asarray(oz), jnp.asarray(ow), iters=6)

    np.testing.assert_allclose(np.asarray(poses_d), np.asarray(poses_s),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(lms_d), np.asarray(lms_s),
                               rtol=1e-2, atol=1e-2)
