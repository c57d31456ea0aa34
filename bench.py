"""Headline benchmark: semantic EM-ICP scan alignments per second on a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}. vs_baseline is the speedup over the CPU kd-tree baseline
(semicp.oracle.cpu_baseline — per-class cKDTree + vectorized numpy EM,
the reference's architecture) on the *same* scan pair on this host.

Workload: ~120k points per scan (an HDL-64E scan), 20 semantic classes,
a 20 EM iteration budget. Override with BENCH_N_POINTS / BENCH_CLASSES /
BENCH_REPEATS. The card's name and power limit and a per-phase
steady-state table (covariance preprocess / target prep / NN walk /
E-step reduce / GN / full align) go to stderr, on lines before the JSON
line's, so bottleneck claims are auditable. Without a GPU it exits
non-zero and reports nothing.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _steady_ms(fn, *args, reps=10):
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def bench_pair(n_points: int = 120000, n_classes: int = 20, seed: int = 0):
    """The bench's scan pair: a structured scene and a displaced,
    noisy, partially dropped copy. Returns (src_pts, src_lab, tgt_pts,
    tgt_lab, T_gt) with x_tgt = T_gt x_src."""
    from semicp.data import make_pair, make_scene

    rng = np.random.default_rng(seed)
    tgt_pts, tgt_lab = make_scene(rng, n_points=n_points, extent=40.0,
                                  n_classes=n_classes)
    tgt_lab = tgt_lab - 1
    delta = np.array([0.5, -0.2, 0.05, 0.01, -0.02, 0.04])
    src_pts, src_lab, T_gt = make_pair(
        rng, tgt_pts, tgt_lab, delta, noise=0.02, dropout=0.1,
        n_classes=n_classes)
    return src_pts, src_lab, tgt_pts, tgt_lab, T_gt


def bench_config(n_points: int = 120000, n_classes: int = 20):
    from semicp.config import Config

    return Config().override({
        "cloud.n_pad": 1 << int(np.ceil(np.log2(n_points))),
        "cloud.num_classes": n_classes,
        "em.max_iters": 20,
    })


def phase_table(cfg, src, tgt, reps=10):
    """Steady-state ms of each pipeline phase at the bench workload.

    Phases are measured ISOLATED at T = identity — right for ranking
    bottlenecks, but not a wall-clock budget: inside the EM loop the
    candidate lists shrink as the pose converges, so the rows sum to
    more than the e2e align time.
    """
    import jax
    import jax.numpy as jnp

    from semicp.cloud import preprocess_cloud
    from semicp.corr.sparse_nn import class_nn_attrs_sparse, prepare_sparse
    from semicp.geom import sym3
    from semicp.register.em_icp import _log_sem
    from semicp.register.estep import estep_reduce
    from semicp.register.gauss_newton import gn_solve

    K = cfg.cloud.num_classes
    rows = []

    # Full Config: includes the canonical class-major Morton sort, same
    # as the product path, so the row reflects true per-scan prep cost.
    pre_fn = jax.jit(lambda c: preprocess_cloud(c, cfg))
    raw = src.replace(cov6=jnp.zeros_like(src.cov6), layout="raw")
    ms, _ = _steady_ms(pre_fn, raw, reps=max(reps // 2, 2))
    rows.append(("cov preprocess+sort", ms))

    prep_fn = jax.jit(lambda c: prepare_sparse(c, K, cfg.corr.cell))
    ms, prep = _steady_ms(prep_fn, tgt, reps=reps)
    rows.append(("target sparse prep", ms))

    nn_fn = jax.jit(lambda p, c: class_nn_attrs_sparse(
        p, c.xyz, c.valid, num_classes=K, gate=cfg.corr.max_dist))
    ms, (nn_d2, attrs) = _steady_ms(nn_fn, prep, src, reps=reps)
    rows.append(("NN walk (sparse)", ms))

    T = jnp.eye(4, dtype=jnp.float32)
    red_fn = jax.jit(lambda d2, at, c: estep_reduce(
        d2, at, jnp.stack(sym3.rotate(T[:3, :3], tuple(c.cov6))), c.xyz,
        _log_sem(c, cfg), c.valid, cfg.corr.max_dist ** 2))
    ms, (a6, b3, c, _) = _steady_ms(red_fn, nn_d2, attrs, src, reps=reps)
    rows.append(("E-step reduce", ms))

    gn_fn = jax.jit(lambda a6, b3, c, xyz: gn_solve(
        T, tuple(xyz), tuple(a6[i] for i in range(6)),
        tuple(b3[i] for i in range(3)), c, cfg.gn))
    ms, _ = _steady_ms(gn_fn, a6, b3, c, src.xyz, reps=reps)
    rows.append((f"GN solve (x{cfg.gn.max_iters})", ms))
    return rows


def main():
    import jax

    from semicp.cli.common import setup_jax
    from semicp.utils.device import card_info, require_gpu

    setup_jax()
    device = require_gpu()
    print(f"# card: {card_info()}", file=sys.stderr)

    from semicp.cloud import make_cloud, preprocess_cloud
    from semicp.oracle import OracleParams
    from semicp.oracle.cpu_baseline import (
        estimate_covariances_fast, semantic_icp_fast,
    )
    from semicp.register import make_align_fn
    from semicp.utils import PhaseTimer

    n_points = int(os.environ.get("BENCH_N_POINTS", 120000))
    n_classes = int(os.environ.get("BENCH_CLASSES", 20))
    repeats = int(os.environ.get("BENCH_REPEATS", 10))
    cfg = bench_config(n_points, n_classes)
    n_pad = cfg.cloud.n_pad
    src_pts, src_lab, tgt_pts, tgt_lab, T_gt = bench_pair(n_points, n_classes)

    timer = PhaseTimer()
    raw_src = make_cloud(src_pts, src_lab, n_pad=n_pad)
    raw_tgt = make_cloud(tgt_pts, tgt_lab, n_pad=n_pad)
    # Full Config: preprocess_cloud leaves clouds in the canonical
    # class-major Morton layout the sparse walk needs, so align skips
    # its own sort (the product odometry path does the same).
    pre_fn = jax.jit(lambda c: preprocess_cloud(c, cfg))
    align_fn = make_align_fn(cfg)

    with timer.phase("compile"):
        src = pre_fn(raw_src)
        tgt = pre_fn(raw_tgt)
        jax.block_until_ready(align_fn(src, tgt))

    # Steady state: one scan of odometry work = preprocess the incoming
    # scan + align it against the (already-preprocessed) previous scan.
    with timer.phase("scan_loop"):
        t0 = time.perf_counter()
        for _ in range(repeats):
            src = pre_fn(raw_src)
            res = align_fn(src, tgt)
        jax.block_until_ready(res)
        dt = time.perf_counter() - t0
    scans_per_s = repeats / dt

    # accuracy sanity on the bench workload
    T = np.asarray(res.T, np.float64)
    err = T @ np.linalg.inv(T_gt.astype(np.float64))
    terr = float(np.linalg.norm(err[:3, 3]))

    # CPU baseline (same pair, same parameters); target covariances
    # precomputed, as each scan is preprocessed once and reused as the
    # next frame's target
    p = OracleParams(max_iters=20)
    tgt_cov = estimate_covariances_fast(tgt_pts.astype(np.float64), tgt_lab, p)
    t0 = time.perf_counter()
    semantic_icp_fast(src_pts, src_lab, tgt_pts, tgt_lab, p, tgt_cov=tgt_cov)
    cpu_scans_per_s = 1.0 / (time.perf_counter() - t0)

    lines = [f"# n={n_points} classes={n_classes} iters={int(res.iterations)} "
             f"trans_err={terr:.6f}m cpu={cpu_scans_per_s:.4f} scans/s",
             "# phases measured isolated at T=identity "
             "(bottleneck ranking, not an e2e budget)"]
    for name, ms in phase_table(cfg, src, tgt, reps=max(repeats // 2, 3)):
        lines.append(f"# phase {name:24s} {ms:9.3f} ms")
    print("\n".join(lines) + "\n" + timer.table(), file=sys.stderr)
    print(json.dumps({
        "metric": "semantic_em_icp_scans_per_s",
        "value": scans_per_s,
        "unit": "scans/s",
        "vs_baseline": scans_per_s / cpu_scans_per_s,
        "device": device,
    }))


if __name__ == "__main__":
    main()
