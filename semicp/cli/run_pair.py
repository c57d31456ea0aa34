"""Pairwise alignment driver — config 1 (BASELINE.json:7).

Reference counterpart: the pairwise PCD align main (SURVEY.md §2.1 row
"Pairwise align driver", §3.1): load two labeled scans, align, print the
transform and timing.

Usage:
  python -m semicp.cli.run_pair --src scan0.bin --tgt scan1.bin \
      [--src-labels s0.label --tgt-labels s1.label] [--voxel 0.25] \
      [--synthetic N] [--em.max_iters=40 ...config overrides] [--jsonl out.jsonl]
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from semicp.config import Config, parse_overrides
from semicp.cli.common import load_scan_np, print_result, setup_jax, to_device_cloud
from semicp.register import make_align_fn
from semicp.utils import MetricsLogger, PhaseTimer
from semicp.utils.device import require_gpu


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src")
    ap.add_argument("--tgt")
    ap.add_argument("--src-labels")
    ap.add_argument("--tgt-labels")
    ap.add_argument("--voxel", type=float, default=0.0)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate a synthetic pair with N points instead of loading files")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the steady-state "
                         "aligns into DIR (TensorBoard/perfetto format)")
    ap.add_argument("--t-init", default=None, metavar="T",
                    help="initial guess: 16 (4x4 row-major) or 12 (3x4 "
                         "KITTI row) whitespace/comma-separated floats — "
                         "the reference align(target, init_T) surface")
    return ap


def parse_t_init(text: str) -> np.ndarray:
    vals = np.array([float(v) for v in text.replace(",", " ").split()],
                    np.float32)
    if vals.size == 12:
        vals = np.concatenate([vals, np.array([0, 0, 0, 1], np.float32)])
    if vals.size != 16:
        raise ValueError(
            f"--t-init needs 12 or 16 floats, got {vals.size}")
    return vals.reshape(4, 4)


def main(argv=None):
    setup_jax()
    require_gpu(allow_cpu=True)
    argv = argv if argv is not None else sys.argv[1:]
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    overrides = parse_overrides(extra)
    cfg = Config().override(overrides)

    timer = PhaseTimer()
    if args.synthetic:
        from semicp.data import make_pair, make_scene

        rng = np.random.default_rng(0)
        tgt_pts, tgt_lab = make_scene(rng, n_points=args.synthetic)
        tgt_lab = tgt_lab - 1
        delta = np.array([0.4, -0.2, 0.05, 0.02, -0.01, 0.05])
        src_pts, src_lab, T_gt = make_pair(rng, tgt_pts, tgt_lab, delta, n_classes=6)
        if "cloud.num_classes" not in overrides:   # never clobber the user's
            cfg = cfg.override({"cloud.num_classes": 8})
    else:
        if not (args.src and args.tgt):
            ap.error("--src/--tgt or --synthetic required")
        with timer.phase("load"):
            src_pts, src_lab = load_scan_np(args.src, args.src_labels, args.voxel)
            tgt_pts, tgt_lab = load_scan_np(args.tgt, args.tgt_labels, args.voxel)
        T_gt = None

    with timer.phase("preprocess"):
        src = to_device_cloud(src_pts, src_lab, cfg)
        tgt = to_device_cloud(tgt_pts, tgt_lab, cfg)
        jax.block_until_ready((src, tgt))

    T0 = parse_t_init(args.t_init) if args.t_init else None
    align_fn = make_align_fn(cfg)
    with timer.phase("compile+first_align"):
        res = align_fn(src, tgt, T0)
        jax.block_until_ready(res)
    if args.profile:
        # SURVEY.md §5 tracing: capture the steady-state align under the
        # profiler (block_until_ready discipline for honest spans)
        with jax.profiler.trace(args.profile):
            res = align_fn(src, tgt, T0)
            jax.block_until_ready(res)
        print(f"profile written to {args.profile}", file=sys.stderr)
    for _ in range(args.repeat - 1):
        with timer.phase("align"):
            res = align_fn(src, tgt, T0)
            jax.block_until_ready(res)

    T = np.asarray(res.T, np.float64)
    out = {
        "T": T.reshape(-1).tolist(),
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "cost": float(res.cost),
        "n_corr": float(res.n_corr),
        "n_src": int(len(src_pts)),
        "n_tgt": int(len(tgt_pts)),
        "timing": timer.summary(),
    }
    if T_gt is not None:
        err = T @ np.linalg.inv(np.asarray(T_gt, np.float64))
        out["trans_err_m"] = float(np.linalg.norm(err[:3, 3]))
        out["rot_err_rad"] = float(
            np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
        )
    with MetricsLogger(args.jsonl) as ml:
        ml.log(**out)
    print_result("run_pair", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
