"""Smoke test of the main path on a GPU: end to end, at full width.

    python chip_smoke.py             # one card
    python chip_smoke.py --chips 4   # the paths that span four cards only

One process, one card by default. The phases, in order, each print a
line and any failure exits non-zero:

  device    the card's name and power limit (nvidia-smi), JAX's platform,
            device kind and device count; fails unless the platform is gpu
  compile   preprocess_cloud and make_align_fn at the bench shape (120k
            points, n_pad 131072, K=20, 20 EM iterations), with
            memory_analysis()
  kernels   the block-sparse NN walk, as compiled for the card, against
            the brute-force search (the full 131072-point target, an
            8192-query slice); the sparse moments walk against the dense
            sweep on the same cloud
  gpu-tests the tests marked `gpu` (pytest -m gpu), in this process
  align     make_align_fn on the bench pair against ground truth and
            against the CPU kd-tree baseline
  drivers   run_pair, run_odometry and run_slam through main(argv) at
            120k points per scan

With --chips 4 it runs only what spans cards, each against its
one-device result: run_batch's data parallelism over a 4-device "pairs"
mesh, the ring NN over 4 map blocks, the distributed scan-to-map align
(run_slam --dist) and the Schur BA.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Precision: every program runs with float32 matmuls pinned to "highest"
(no TF32), as the package sets at import; each tolerance below says
which error it covers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

N_POINTS = 120000      # one HDL-64E scan (padded to 131072)
N_CLASSES = 20         # SemanticKITTI's label set
F32_EPS = 2.0 ** -23


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def phase_compile(cfg, raw_src, raw_tgt):
    import jax
    import jax.numpy as jnp

    from semicp.cloud import preprocess_cloud
    from semicp.register.em_icp import _align_jit

    pre = jax.jit(lambda c: preprocess_cloud(c, cfg))
    t0 = time.perf_counter()
    pre_c = pre.lower(raw_src).compile()
    say("compile", f"preprocess_cloud {time.perf_counter() - t0:.1f} s; "
        f"{pre_c.memory_analysis()}")
    src, tgt = pre_c(raw_src), pre_c(raw_tgt)
    t0 = time.perf_counter()
    align_c = _align_jit.lower(src, tgt, jnp.eye(4, dtype=jnp.float32),
                               jnp.float32(cfg.corr.max_dist),
                               jnp.int32(cfg.em.max_iters), cfg).compile()
    say("compile", f"make_align_fn {time.perf_counter() - t0:.1f} s; "
        f"{align_c.memory_analysis()}")
    return pre_c, src, tgt


def _max_norm2(xyz, valid) -> float:
    x = np.asarray(xyz, np.float64)[:, np.asarray(valid)]
    return float(np.max(np.sum(x * x, 0)))


def check_nn(prep, tgt, q_xyz, q_valid, num_classes, gate):
    """The sparse walk against the brute force: d2 within the expanded
    form's cancellation bound for every correspondence inside the gate,
    and the same winner wherever it is unique."""
    import jax

    from semicp.corr.sparse_nn import class_nn_attrs_sparse, class_nn_attrs_xla

    (d2_s, at_s), t_s = _timed(lambda: class_nn_attrs_sparse(
        prep, q_xyz, q_valid, num_classes=num_classes, gate=gate))
    ref = jax.jit(class_nn_attrs_xla, static_argnames="num_classes")
    (d2_x, at_x), t_x = _timed(lambda: ref(
        tgt.xyz, tgt.label, tgt.valid, tgt.cov6, q_xyz,
        num_classes=num_classes))
    d2_s, at_s, d2_x, at_x = map(np.asarray, (d2_s, at_s, d2_x, at_x))
    q = np.asarray(q_xyz, np.float64)
    # both sides expand d2 = |q|^2 + |t|^2 - 2 q.t in f32: each loses up
    # to ~(|q|^2 + |t|^2) * eps to cancellation; 4x covers both sides
    tol = 4.0 * 2.0 * max(_max_norm2(q_xyz, q_valid),
                          _max_norm2(tgt.xyz, tgt.valid)) * F32_EPS
    inside = (d2_x <= gate * gate * (1 - 1e-5)) & np.asarray(q_valid)[None]
    err = float(np.max(np.abs(d2_s - d2_x)[inside])) if inside.any() else 0.0
    # winners may differ only at near-ties: then their exact distances
    # to the query agree within tol
    diff = (at_s != at_x).any(axis=1) & inside
    kk, qq = np.nonzero(diff)
    ex_s = np.sum((at_s[kk, :3, qq].astype(np.float64) - q[:, qq].T) ** 2, 1)
    ex_x = np.sum((at_x[kk, :3, qq].astype(np.float64) - q[:, qq].T) ** 2, 1)
    tie_err = float(np.max(np.abs(ex_s - ex_x))) if len(kk) else 0.0
    say("kernels", f"NN walk vs brute force: {int(inside.sum())} correspondences "
        f"in gate, max |d2 err| {err:.3e} m^2 (tol {tol:.3e}, f32 expansion "
        f"bound), {len(kk)} near-tie winners (max exact-d2 gap "
        f"{tie_err:.3e}); walk {t_s * 1e3:.1f} ms, brute force "
        f"{t_x * 1e3:.1f} ms (first calls, compile included)")
    if not inside.any() or err > tol or tie_err > tol:
        raise AssertionError("sparse NN walk disagrees with the brute force")


def check_moments(cloud, cfg):
    """The sparse moments walk against the dense sweep on one cloud."""
    import jax
    import jax.numpy as jnp

    from semicp.cloud.covariance import estimate_radius
    from semicp.cloud.moments import (
        neighborhood_moments_sparse, neighborhood_moments_xla,
    )

    label = jnp.maximum(cloud.label, 0)
    radius = estimate_radius(cloud.xyz, label, cloud.valid, k=cfg.cov.k)
    m_s, t_s = _timed(lambda: neighborhood_moments_sparse(
        cloud.xyz, label, cloud.valid, radius, num_classes=N_CLASSES))
    m_x, t_x = _timed(lambda: jax.jit(neighborhood_moments_xla)(
        cloud.xyz, label, cloud.valid, radius))
    m_s, m_x = np.asarray(m_s, np.float64), np.asarray(m_x, np.float64)
    valid = np.asarray(cloud.valid)

    def cov(m):
        n = np.maximum(m[0], 1.0)
        mean = m[1:4] / n
        s2 = m[4:7] / n
        return s2 - mean * mean

    cnt_err = float(np.max(np.abs(m_s[0] - m_x[0])[valid]))
    ok = valid & (m_x[0] >= 3) & (m_s[0] == m_x[0])
    # the dense sweep sums UNCENTRED f32 moments, so each of its variances
    # carries up to ~|x|^2 * eps per summand of cancellation error (the
    # walk centres per tile): tolerance 1e-3 relative + 16 |x|^2 eps
    x2 = np.sum(np.asarray(cloud.xyz, np.float64) ** 2, 0)
    err = np.abs(cov(m_s) - cov(m_x))[:, ok]
    bound = (1e-3 * np.abs(cov(m_x)) + 16.0 * x2 * F32_EPS)[:, ok]
    worst = float(np.max(err / bound))
    say("kernels", f"moments walk vs dense sweep: radius {float(radius):.3f} m,"
        f" mean count {m_x[0][valid].mean():.1f}, max count diff {cnt_err:.0f} "
        f"(tol 1: radius-boundary ties), max variance err {err.max():.3e} m^2 "
        f"= {worst:.2f} x its bound (1e-3 relative + 16 |x|^2 eps, the dense "
        f"sweep's cancellation); walk {t_s * 1e3:.1f} ms, dense "
        f"{t_x * 1e3:.1f} ms (first calls)")
    checked = ok.sum() / max(int((valid & (m_x[0] >= 3)).sum()), 1)
    if cnt_err > 1 or worst > 1.0 or checked < 0.99:
        raise AssertionError("sparse moments walk disagrees with the dense sweep")


def phase_kernels(cfg, src, tgt):
    import jax.numpy as jnp

    from semicp.corr.sparse_nn import prepare_sparse

    prep = prepare_sparse(tgt, N_CLASSES, cfg.corr.cell)
    # an 8192-query slice, strided so it spans every class and region
    check_nn(prep, tgt, src.xyz[:, ::16], src.valid[::16], N_CLASSES,
             jnp.float32(cfg.corr.max_dist))
    check_moments(src, cfg)


def phase_gpu_tests():
    """The tests marked `gpu`, in this process, on this card."""
    import pytest

    os.environ["SEMICP_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests")])
    say("gpu-tests", f"pytest -m gpu exit code {int(rc)}")
    if rc != 0:
        raise AssertionError("tests marked gpu failed")


def phase_align(cfg, src, tgt, pts):
    from semicp.oracle import OracleParams
    from semicp.oracle.cpu_baseline import semantic_icp_fast
    from semicp.register import make_align_fn

    src_pts, src_lab, tgt_pts, tgt_lab, T_gt = pts
    align = make_align_fn(cfg)
    align(src, tgt)
    res, dt = _timed(lambda: align(src, tgt))

    def errs(T, T_ref):
        e = np.asarray(T, np.float64) @ np.linalg.inv(np.asarray(T_ref, np.float64))
        R = e[:3, :3]
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        angle = np.arctan2(np.linalg.norm(w), (np.trace(R) - 1) / 2)
        return float(np.linalg.norm(e[:3, 3])), float(angle)

    t_err, r_err = errs(res.T, T_gt)
    say("align", f"make_align_fn: {int(res.iterations)} EM iterations, "
        f"converged={bool(res.converged)}, trans err {t_err * 1e3:.3f} mm, "
        f"rot err {r_err * 1e3:.4f} mrad vs ground truth; {dt * 1e3:.1f} ms")
    T_cpu, info = semantic_icp_fast(src_pts, src_lab, tgt_pts, tgt_lab,
                                    OracleParams(max_iters=cfg.em.max_iters))
    t_gap, r_gap = errs(res.T, T_cpu)
    say("align", f"CPU baseline ({info['iterations']} iterations): GPU-vs-CPU gap "
        f"{t_gap * 1e3:.3f} mm, {r_gap * 1e3:.4f} mrad (tol 10 mm, 2 mrad: "
        "the baseline's kNN covariances vs the radius covariances)")
    if not (bool(res.converged) and t_err < 0.01 and r_err < 0.002
            and t_gap < 0.01 and r_gap < 0.002):
        raise AssertionError("align disagrees with ground truth or the baseline")


def phase_drivers(tmp, n_points, n_pad):
    from semicp.cli import run_odometry, run_pair, run_slam

    width = [f"--cloud.n_pad={n_pad}"]
    out, dt = _timed(lambda: run_pair.main(
        ["--synthetic", str(n_points)] + width))
    say("drivers", f"run_pair: {out['iterations']} iterations, "
        f"trans err {out['trans_err_m'] * 1e3:.3f} mm; {dt:.1f} s")
    if not (out["converged"] and out["trans_err_m"] < 0.01):
        raise AssertionError("run_pair did not converge to ground truth")

    out, dt = _timed(lambda: run_odometry.main(
        ["--synthetic", "5", "--n-points", str(n_points), "--prefetch", "0",
         "--out", os.path.join(tmp, "odom.txt")] + width))
    say("drivers", f"run_odometry: {out['frames']} frames, ATE "
        f"{out['ate_rmse_m'] * 1e3:.3f} mm; {dt:.1f} s")
    if not (out["frames"] == 5 and out["ate_rmse_m"] < 0.05):
        raise AssertionError("run_odometry failed")

    out, dt = _timed(lambda: run_slam.main(
        ["--synthetic", "5", "--n-points", str(n_points),
         "--out", os.path.join(tmp, "slam.txt")] + width))
    say("drivers", f"run_slam: {out['frames']} frames, {out['keyframes']} "
        f"keyframes, {out['edges']} edges, ATE {out['ate_rmse_m'] * 1e3:.3f} "
        f"mm; {dt:.1f} s")
    if not (out["frames"] == 5 and out["edges"] >= 1
            and out["ate_rmse_m"] < 0.05):
        raise AssertionError("run_slam failed")


def run_single(n_points: int = N_POINTS):
    from bench import bench_config, bench_pair

    from semicp.cloud import make_cloud

    cfg = bench_config(n_points, N_CLASSES)
    pts = bench_pair(n_points, N_CLASSES)
    raw_src = make_cloud(pts[0], pts[1], n_pad=cfg.cloud.n_pad)
    raw_tgt = make_cloud(pts[2], pts[3], n_pad=cfg.cloud.n_pad)
    _, src, tgt = phase_compile(cfg, raw_src, raw_tgt)
    phase_kernels(cfg, src, tgt)
    phase_gpu_tests()
    phase_align(cfg, src, tgt, pts)
    with tempfile.TemporaryDirectory() as tmp:
        phase_drivers(tmp, n_points, cfg.cloud.n_pad)


def multi_batch(devices, n_points):
    """run_batch's data parallelism: one scan pair per card vs one card."""
    import jax
    import jax.numpy as jnp

    from bench import bench_config, bench_pair
    from semicp.cloud import make_cloud, preprocess_cloud
    from semicp.dist import batched_align, make_mesh
    from semicp.dist.batch import shard_batch
    from semicp.register import make_align_fn

    n = len(devices)
    cfg = bench_config(n_points, N_CLASSES)
    pre = jax.jit(jax.vmap(lambda c: preprocess_cloud(c, cfg)))
    pairs = [bench_pair(n_points, N_CLASSES, seed=s) for s in range(n)]

    def stack(clouds):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)

    src = pre(stack([make_cloud(p[0], p[1], n_pad=cfg.cloud.n_pad) for p in pairs]))
    tgt = pre(stack([make_cloud(p[2], p[3], n_pad=cfg.cloud.n_pad) for p in pairs]))
    mesh = make_mesh({"pairs": n}, devices=devices)
    T0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 4, 4))
    align_b = batched_align(mesh, cfg)
    args = [shard_batch(mesh, x) for x in (src, tgt, T0)]
    align_b(*args)
    res, dt = _timed(lambda: align_b(*args))
    one = make_align_fn(cfg)
    gaps = []
    for s in range(n):
        r1 = one(jax.tree.map(lambda x: x[s], src), jax.tree.map(lambda x: x[s], tgt))
        gaps.append(float(np.abs(np.asarray(res.T)[s] - np.asarray(r1.T)).max()))
    say("batch", f"{n} pairs of {n_points} points over a {n}-card 'pairs' mesh: "
        f"{dt * 1e3:.1f} ms; max |T - T_one_card| {max(gaps):.2e} (tol 1e-4: "
        "f32 reduction order under vmap)")
    if max(gaps) > 1e-4:
        raise AssertionError("batched align disagrees with the one-card align")


def multi_ring_and_dist(devices, n_points):
    """Ring NN over n map blocks and the distributed scan-to-map align,
    each against the one-card result."""
    import jax
    import jax.numpy as jnp

    from bench import bench_config
    from semicp.cloud import make_cloud, preprocess_cloud
    from semicp.corr.sparse_nn import class_nn_attrs_xla
    from semicp.data import make_pair, make_scene
    from semicp.dist import make_mesh
    from semicp.dist.align_dist import make_dist_align_fn
    from semicp.dist.ring_corr import make_ring_nn
    from semicp.register import make_align_fn

    n = len(devices)
    cfg = bench_config(n_points, N_CLASSES)
    n_pad = cfg.cloud.n_pad
    n_map = n * n_pad
    cfg_map = cfg.override({"cloud.n_pad": n_map})
    # a map n times denser than a scan over the same extent (a fused
    # submap), and one scan of it, displaced
    rng = np.random.default_rng(1)
    map_pts, map_lab = make_scene(rng, n_points=n * n_points, extent=40.0,
                                  n_classes=N_CLASSES)
    map_lab = map_lab - 1
    delta = np.array([0.5, -0.2, 0.05, 0.01, -0.02, 0.04])
    src_pts, src_lab, _ = make_pair(rng, map_pts, map_lab, delta, noise=0.02,
                                    dropout=0.1, n_classes=N_CLASSES)
    pick = rng.choice(len(src_pts), n_points, replace=False)
    src = jax.jit(lambda c: preprocess_cloud(c, cfg))(
        make_cloud(src_pts[pick], src_lab[pick], n_pad=n_pad))
    tgt = jax.jit(lambda c: preprocess_cloud(c, cfg_map))(
        make_cloud(map_pts, map_lab, n_pad=n_map))
    mesh = make_mesh({"blocks": n}, devices=devices)

    gate = cfg.corr.max_dist
    ring = make_ring_nn(mesh, num_classes=N_CLASSES, gate=gate)
    q = src.xyz[:, ::max(n_pad // (2048 * n), 1)]
    ring(q, tgt.xyz, tgt.label, tgt.valid, tgt.cov6)
    (d2, at), dt = _timed(lambda: ring(q, tgt.xyz, tgt.label, tgt.valid, tgt.cov6))
    ref = jax.jit(class_nn_attrs_xla, static_argnames="num_classes")
    d2_x, at_x = map(np.asarray, ref(tgt.xyz, tgt.label, tgt.valid, tgt.cov6,
                                     q, num_classes=N_CLASSES))
    d2, at = np.asarray(d2), np.asarray(at)
    inside = d2_x <= gate * gate * (1 - 1e-5)
    tol = 4.0 * 2.0 * float(np.max(np.sum(map_pts.astype(np.float64) ** 2, 1))) * F32_EPS
    err = float(np.max(np.abs(d2 - d2_x)[inside]))
    say("ring", f"ring NN over {n} blocks of {n_pad} map points, {q.shape[1]} "
        f"queries: {dt * 1e3:.1f} ms; max |d2 err| {err:.3e} (tol {tol:.3e}, "
        "f32 expansion bound)")
    if not inside.any() or err > tol:
        raise AssertionError("ring NN disagrees with the one-card brute force")

    dist_align = make_dist_align_fn(mesh, cfg)
    dist_align(src, tgt)
    res, dt = _timed(lambda: dist_align(src, tgt))
    r1 = make_align_fn(cfg)(src, tgt)
    gap = float(np.abs(np.asarray(res.T) - np.asarray(r1.T)).max())
    say("dist", f"scan-to-map align of {n_pad} points against {n_map} over "
        f"{n} cards: {int(res.iterations)} iterations, {dt * 1e3:.1f} ms; max "
        f"|T - T_one_card| {gap:.2e} (tol 1e-3: psum order of the 6x6 "
        "normal equations)")
    if not bool(res.converged) or gap > 1e-3:
        raise AssertionError("distributed align disagrees with the one-card align")


def multi_schur(devices, m=8, n_lm=8192, obs_per_lm=3):
    """The Schur-complement BA over n landmark shards vs one card."""
    import jax.numpy as jnp

    from semicp.dist import make_mesh
    from semicp.geom.se3 import se3_exp
    from semicp.slam.schur import ba_solve_single, make_ba_solver

    n = len(devices)
    rng = np.random.default_rng(0)
    poses = [np.eye(4)]
    for _ in range(1, m):
        d = np.array([1.0, 0.1, 0, 0.01, 0, 0.05], np.float32)
        poses.append(poses[-1] @ np.asarray(se3_exp(jnp.asarray(d)), np.float64))
    lms = rng.uniform(-5, 15, size=(n_lm, 3))
    per = n_lm // n
    obs = [[] for _ in range(n)]
    for lm in range(n_lm):
        for i in rng.choice(m, size=obs_per_lm, replace=False):
            Ti = np.linalg.inv(poses[i])
            z = Ti[:3, :3] @ lms[lm] + Ti[:3, 3] + rng.normal(size=3) * 0.01
            obs[lm // per].append((i, lm, z))
    p0 = np.stack(poses).astype(np.float32)
    for i in range(1, m):
        p0[i] = p0[i] @ np.asarray(se3_exp(jnp.asarray(
            (rng.normal(size=6) * 0.01).astype(np.float32))))
    l0 = (lms + rng.normal(size=lms.shape) * 0.1).astype(np.float32)
    omax = max(len(o) for o in obs)
    OI = np.zeros((n, omax), np.int32)
    OL = np.zeros((n, omax), np.int32)
    OZ = np.zeros((n, omax, 3), np.float32)
    OW = np.zeros((n, omax), np.float32)
    for d, ob in enumerate(obs):
        for j, (i, lm, z) in enumerate(ob):
            OI[d, j], OL[d, j], OZ[d, j], OW[d, j] = i, lm - d * per, z, 1.0
    mesh = make_mesh({"blocks": n}, devices=devices)
    solver = make_ba_solver(mesh, m=m, iters=6)
    args = [jnp.asarray(a) for a in (p0, l0, OI.reshape(-1), OL.reshape(-1),
                                     OZ.reshape(-1, 3), OW.reshape(-1))]
    solver(*args)
    (pd, ld), dt = _timed(lambda: solver(*args))
    gi = (OL + np.arange(n)[:, None] * per).reshape(-1)
    ps, ls = ba_solve_single(args[0], args[1], args[2], jnp.asarray(gi),
                             args[4], args[5], iters=6)
    gap_p = float(np.abs(np.asarray(pd) - np.asarray(ps)).max())
    gap_l = float(np.abs(np.asarray(ld) - np.asarray(ls)).max())
    say("schur", f"BA of {m} poses and {n_lm} landmarks over {n} cards: "
        f"{dt * 1e3:.1f} ms; max pose gap {gap_p:.2e} (tol 1e-3), landmark "
        f"gap {gap_l:.2e} (tol 1e-2): psum order in f32")
    if gap_p > 1e-3 or gap_l > 1e-2:
        raise AssertionError("mesh BA disagrees with the one-card solve")


def run_multi(devices, n_points: int = N_POINTS):
    multi_batch(devices, n_points)
    multi_ring_and_dist(devices, n_points)
    multi_schur(devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the paths that span four cards")
    args = ap.parse_args(argv)

    from semicp.cli.common import setup_jax
    from semicp.utils.device import card_info, require_gpu

    setup_jax()
    device = require_gpu()
    import jax

    say("device", card_info())
    say("device", f"platform={device['platform']} kind={device['kind']} "
        f"count={device['count']}")
    if device["count"] < args.chips:
        sys.exit(f"--chips {args.chips}: only {device['count']} devices")
    if args.chips == 4:
        run_multi(jax.devices()[:4])
    else:
        run_single()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
