"""Multi-sequence batch odometry / batch SLAM — config 5 (BASELINE.json:11).

S sequences advance in lockstep; each step aligns S scan pairs as ONE
mesh-sharded batched program (scan-pair DP over the "pairs" axis,
SURVEY.md §2.3): every device runs the full EM alignment for its shard
of sequences. Preprocessing is likewise one vmapped program over the
batch. Host-side per-sequence pose chaining + ATE.

`--slam` runs FULL batch SLAM per sequence: keyframing, semantic-
descriptor loop-closure proposal, batched wide-gate verification (all
sequences' candidates verified in ONE mesh-sharded align — gate and
iteration budget are runtime operands of the same compiled odometry
program), per-sequence pose-graph optimization, and trajectory
recomposition — the per-sequence logic mirrors cli/run_slam.py, so a
batched run reproduces S independent run_slam runs (pinned by
tests/test_batch_slam.py).

This is the scaling-study driver: aggregate frames/s versus mesh size
is the BASELINE.json:5 efficiency metric, measured over a host's cards.

Usage:
  python -m semicp.cli.run_batch --synthetic 30 --sequences 8 [--n-points 2000]
  python -m semicp.cli.run_batch --synthetic 40 --slam --loop --drift 0.004
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from semicp.cli.common import print_result, setup_jax
from semicp.cloud import make_cloud, preprocess_cloud
from semicp.config import Config, parse_overrides
from semicp.dist import batched_align, make_mesh
from semicp.dist.batch import shard_batch
from semicp.utils import MetricsLogger, PhaseTimer
from semicp.utils.device import require_gpu


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", type=int, required=True, help="frames per sequence")
    ap.add_argument("--sequences", type=int, default=0,
                    help="number of sequences (default: one per device)")
    ap.add_argument("--n-points", type=int, default=2000)
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--slam", action="store_true",
                    help="full batch SLAM per sequence (keyframes, batched "
                         "loop-closure verification, PGO) instead of plain "
                         "batched odometry")
    ap.add_argument("--loop", action="store_true",
                    help="--slam synthetic: drive closed loops")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="--slam synthetic: per-frame yaw drift (rad)")
    ap.add_argument("--max-keyframes", type=int, default=128)
    ap.add_argument("--max-edges", type=int, default=512)
    return ap


def run_batch_slam(args, cfg: Config):
    """Config 5 proper: S sequences of FULL SLAM in lockstep.

    Device work is batched across sequences (odometry aligns and loop-
    closure verifications each run as one mesh-sharded program); the
    host control plane (keyframe decisions, candidate gating, graph
    bookkeeping, PGO dispatch) runs per sequence, mirroring
    cli/run_slam.py's logic so results match S independent runs.
    """
    from semicp.cli.run_slam import synthetic_loop_frames
    from semicp.geom.se3 import se3_exp
    from semicp.slam import propose_loop_closures
    from semicp.slam.keyframes import (
        KeyframeStore, keyframe_due, semantic_descriptor,
    )
    from semicp.slam.loop_closure import edge_info_from_hessian
    from semicp.slam.pose_graph import (
        PoseGraph, add_edge, add_pose, optimize_pose_graph,
    )

    timer = PhaseTimer()
    n_avail = len(jax.devices())
    S = args.sequences or n_avail
    # mesh over the largest device count that divides S (S=2 sequences
    # on an 8-device test mesh run on 2 devices)
    n_dev = (n_avail if S % n_avail == 0 else
             max(d for d in range(1, min(S, n_avail) + 1) if S % d == 0))
    mesh = make_mesh({"pairs": n_dev}, devices=jax.devices()[:n_dev])
    align_b = batched_align(mesh, cfg)
    pre_batch = jax.jit(jax.vmap(lambda c: preprocess_cloud(c, cfg)))

    with timer.phase("generate"):
        seqs = [synthetic_loop_frames(args.synthetic, args.n_points,
                                      closed=args.loop, seed=s)
                for s in range(S)]

    def stack_clouds(clouds):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)

    def seq_cloud(batch, s):
        return jax.tree.map(lambda x: x[s], batch)

    graphs = [PoseGraph.empty(args.max_keyframes, args.max_edges)
              for _ in range(S)]
    stores = [KeyframeStore() for _ in range(S)]
    anchors: list[list] = [[] for _ in range(S)]
    T_now = [np.eye(4) for _ in range(S)]
    T_rel_prev = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    n_loop_edges = [0] * S
    drift_T = (np.asarray(se3_exp(jnp.asarray(
        np.array([0, 0, 0, 0, 0, args.drift], np.float32))), np.float64)
        if args.drift else None)

    def flush_verifications(reqs):
        """Verify ALL sequences' loop-closure candidates in ONE batched
        wide-gate align (pad to a device multiple with repeats)."""
        if not reqs:
            return []
        padded = reqs + [reqs[0]] * (-len(reqs) % n_dev)
        src_b = stack_clouds([stores[s][j].cloud for s, c, j, _ in padded])
        tgt_b = stack_clouds([stores[s][c].cloud for s, c, j, _ in padded])
        T0_b = jnp.asarray(np.stack([Ti for *_, Ti in padded]), jnp.float32)
        src_b, tgt_b, T0_b = (shard_batch(mesh, x)
                              for x in (src_b, tgt_b, T0_b))
        res = align_b(src_b, tgt_b, T0_b,
                      gate=cfg.slam.lc_max_dist / 2.0, max_iters=40)
        conv = np.asarray(res.converged)
        n_corr = np.asarray(res.n_corr)
        Z_all = np.asarray(res.T, np.float64)
        H_all = np.asarray(res.H, np.float64)
        out = []
        for r, (s, c, j, _) in enumerate(reqs):
            ok = bool(conv[r]) and float(n_corr[r]) > 0.25 * float(
                stores[s][j].cloud.count)
            if ok:
                out.append((s, c, j, Z_all[r], H_all[r]))
        return out

    prev = None
    n_aligns = 0
    t_start = time.perf_counter()
    for t in range(args.synthetic):
        with timer.phase("preprocess"):
            raw = stack_clouds([
                make_cloud(seqs[s][0][t][0], seqs[s][0][t][1],
                           n_pad=cfg.cloud.n_pad)
                for s in range(S)
            ])
            batch = pre_batch(raw)
            jax.block_until_ready(batch)
        if prev is None:
            for s in range(S):
                pts, lab = seqs[s][0][t]
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                stores[s].add(t, T_now[s], seq_cloud(batch, s), desc)
                graphs[s] = add_pose(graphs[s], np.eye(4, dtype=np.float32))
                anchors[s].append((0, np.eye(4)))
            prev = batch
            continue

        with timer.phase("align_batch"):
            src_b, tgt_b, T0_b = (shard_batch(mesh, x)
                                  for x in (batch, prev, jnp.asarray(T_rel_prev)))
            res = align_b(src_b, tgt_b, T0_b)
            jax.block_until_ready(res)
        n_aligns += S
        T_rel_all = np.asarray(res.T, np.float64)
        H_all = np.asarray(res.H, np.float64)

        # batched analog of make_robust_align_fn's health retry: warm
        # starts that landed in a bad basin (detected by correspondence
        # starvation) are re-solved from identity in ONE extra batched
        # align over the suspect subset
        frac = cfg.em.retry_overlap_frac
        if frac > 0.0:
            conv = np.asarray(res.converged)
            n_corr = np.asarray(res.n_corr)
            n_expect = np.minimum(np.asarray(batch.count),
                                  np.asarray(prev.count)).astype(np.float64)
            bad = [s for s in range(S)
                   if not (bool(conv[s])
                           and float(n_corr[s]) >= frac * n_expect[s])]
            if bad:
                padded = bad + [bad[0]] * (-len(bad) % n_dev)
                src_r = stack_clouds([seq_cloud(batch, s) for s in padded])
                tgt_r = stack_clouds([seq_cloud(prev, s) for s in padded])
                T0_r = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                        (len(padded), 4, 4))
                src_r, tgt_r, T0_r = (shard_batch(mesh, x)
                                      for x in (src_r, tgt_r, T0_r))
                res_r = align_b(src_r, tgt_r, T0_r)
                n_aligns += len(bad)
                n_corr_r = np.asarray(res_r.n_corr)
                T_r = np.asarray(res_r.T, np.float64)
                H_r = np.asarray(res_r.H, np.float64)
                for r, s in enumerate(bad):
                    if float(n_corr_r[r]) > float(n_corr[s]):
                        T_rel_all[s] = T_r[r]
                        H_all[s] = H_r[r]

        verify_reqs = []
        new_kf = {}
        for s in range(S):
            T_rel = T_rel_all[s]
            T_rel_prev[s] = T_rel.astype(np.float32)
            if drift_T is not None:
                T_rel = T_rel @ drift_T
            T_now[s] = T_now[s] @ T_rel

            kf_last = stores[s][-1]
            poses_now = np.asarray(graphs[s].poses, np.float64)
            last_kf_pose = poses_now[kf_last.index]
            anchors[s].append((kf_last.index,
                               np.linalg.inv(last_kf_pose) @ T_now[s]))

            if keyframe_due(last_kf_pose, T_now[s], cfg.slam):
                pts, lab = seqs[s][0][t]
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                kf = stores[s].add(t, T_now[s], seq_cloud(batch, s), desc)
                graphs[s] = add_pose(graphs[s],
                                     T_now[s].astype(np.float32))
                Z = np.linalg.inv(last_kf_pose) @ T_now[s]
                graphs[s] = add_edge(graphs[s], kf_last.index, kf.index,
                                     Z.astype(np.float32),
                                     edge_info_from_hessian(H_all[s]),
                                     H=H_all[s])
                new_kf[s] = kf.index
                poses_now = np.asarray(graphs[s].poses, np.float64)
                cands = propose_loop_closures(stores[s], kf, poses_now,
                                              cfg)
                for c in cands[:cfg.slam.lc_max_candidates]:
                    T_init = (np.linalg.inv(poses_now[c])
                              @ poses_now[kf.index])
                    verify_reqs.append((s, c, kf.index, T_init))

        with timer.phase("loop_verify"):
            accepted = flush_verifications(verify_reqs)
        n_aligns += len(verify_reqs)
        pgo_seqs = set()
        for s, c, j, Z, H in accepted:
            graphs[s] = add_edge(graphs[s], c, j, Z.astype(np.float32),
                                 edge_info_from_hessian(H), H=H)
            n_loop_edges[s] += 1
            pgo_seqs.add(s)
        for s in pgo_seqs:
            with timer.phase("pgo"):
                graphs[s] = optimize_pose_graph(graphs[s], cfg.slam)
                jax.block_until_ready(graphs[s])
            T_now[s] = np.asarray(graphs[s].poses, np.float64)[new_kf[s]]
        prev = batch
    wall = time.perf_counter() - t_start

    from semicp.eval import ate_rmse

    trajs, ates = [], []
    for s in range(S):
        if int(graphs[s].n_edges) > 0:
            graphs[s] = optimize_pose_graph(graphs[s], cfg.slam)
        final_kf = np.asarray(graphs[s].poses, np.float64)
        traj = np.stack([final_kf[a] @ rel for a, rel in anchors[s]])
        trajs.append(traj)
        ates.append(ate_rmse(traj, seqs[s][1][: len(traj)]))

    out = {
        "sequences": S,
        "frames_per_seq": args.synthetic,
        "aligns_total": n_aligns,
        "aligns_per_s": round(n_aligns / max(wall, 1e-9), 3),
        "devices": n_dev,
        "keyframes": [len(st) for st in stores],
        "loop_edges": n_loop_edges,
        "ate_rmse_m": [round(a, 4) for a in ates],
        "ate_rmse_mean": float(np.mean(ates)),
        "timing": timer.summary(),
    }
    return out, trajs, timer


def main(argv=None):
    setup_jax()
    require_gpu(allow_cpu=True)
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))

    if args.slam:
        out, _, timer = run_batch_slam(args, cfg)
        print_result("run_batch_slam", out)
        print(timer.table(), file=sys.stderr)
        return out

    n_dev = len(jax.devices())
    S = args.sequences or n_dev
    if S % n_dev:
        ap.error(f"--sequences must be a multiple of the {n_dev} devices")
    mesh = make_mesh({"pairs": n_dev})

    # generate S synthetic sequences (frames in sensor frame + GT)
    from semicp.data import make_scene, make_trajectory, render_scan

    timer = PhaseTimer()
    seqs = []
    with timer.phase("generate"):
        for s in range(S):
            rng = np.random.default_rng(s)
            scene, labels = make_scene(rng, n_points=args.n_points * 4, extent=30.0)
            labels = labels - 1
            traj = make_trajectory(args.synthetic, step=0.6, turn=0.05, seed=s)
            frames = [render_scan(rng, scene, labels, p, max_range=25.0,
                                  max_points=args.n_points) for p in traj]
            seqs.append((frames, traj))

    pre_batch = jax.jit(jax.vmap(lambda c: preprocess_cloud(c, cfg)))
    align_b = batched_align(mesh, cfg)

    def stack_clouds(clouds):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)

    poses = [[np.eye(4)] for _ in range(S)]
    T_rel_prev = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    prev = None
    ml = MetricsLogger(args.jsonl)
    n_aligns = 0
    t_start = time.perf_counter()
    for t in range(args.synthetic):
        with timer.phase("preprocess"):
            raw = stack_clouds([
                make_cloud(seqs[s][0][t][0], seqs[s][0][t][1], n_pad=cfg.cloud.n_pad)
                for s in range(S)
            ])
            batch = pre_batch(raw)
            jax.block_until_ready(batch)
        if prev is not None:
            with timer.phase("align_batch"):
                src_b, tgt_b, T0_b = (shard_batch(mesh, x)
                                      for x in (batch, prev, jnp.asarray(T_rel_prev)))
                res = align_b(src_b, tgt_b, T0_b)
                jax.block_until_ready(res)
            T_rel = np.asarray(res.T, np.float64)
            T_rel_prev = np.asarray(res.T)
            for s in range(S):
                poses[s].append(poses[s][-1] @ T_rel[s])
            n_aligns += S
            ml.log(frame=t, mean_iters=float(np.mean(np.asarray(res.iterations))),
                   mean_cost=float(np.mean(np.asarray(res.cost))))
        prev = batch
    wall = time.perf_counter() - t_start

    from semicp.eval import ate_rmse

    ates = [ate_rmse(np.stack(poses[s]), seqs[s][1][: len(poses[s])]) for s in range(S)]
    out = {
        "sequences": S,
        "frames_per_seq": args.synthetic,
        "aligns_total": n_aligns,
        "aligns_per_s": round(n_aligns / max(wall, 1e-9), 3),
        "devices": n_dev,
        "ate_rmse_m": [round(a, 4) for a in ates],
        "ate_rmse_mean": float(np.mean(ates)),
        "timing": timer.summary(),
    }
    ml.close()
    print_result("run_batch", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
