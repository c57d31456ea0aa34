"""Keyframe SLAM driver — config 3 (BASELINE.json:9).

Host control plane (SURVEY.md §3.3): frame scheduling, keyframe
decisions, loop-closure gating, checkpointing. Device data plane: EM
alignments (odometry + loop verification) and pose-graph GN.

Per frame:
  odometry   align scan onto the previous scan, or — with --scan-to-map
             — onto the current submap (the last `slam.submap_keyframes`
             keyframe clouds fused in the newest keyframe's frame,
             slam/submap.py), warm-started by constant velocity
  keyframe   spawned after enough motion; adds a pose-graph node and an
             odometry edge weighted by the align's GN Hessian
  loop       older keyframes gated by pose proximity + semantic
             descriptor; survivors verified by a wide-gate EM align;
             accepted edges trigger pose-graph optimization and a
             trajectory correction
Every frame stores (anchor keyframe, relative pose); the exported
trajectory recomposes against FINAL optimized keyframe poses, so late
loop closures correct the whole history.

With --dist (config 4, BASELINE.json:10) the submap becomes mesh-sharded
map blocks: scan-to-map odometry runs the distributed EM align (ring NN
over ppermute + psum'd GN, dist/align_dist.py) and the run closes with a
distributed Schur-complement map BA over the same mesh (slam/map_ba.py).

Usage:
  python -m semicp.cli.run_slam --synthetic 120 [--loop] [--scan-to-map] [--dist]
  python -m semicp.cli.run_slam --seq <kitti-seq-dir> [--voxel 0.3]
      [--out poses.txt] [--jsonl metrics.jsonl] [--checkpoint-dir ckpt/ --resume]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import numpy as np

from semicp.cli.common import load_scan_np, print_result, setup_jax, to_device_cloud
from semicp.config import Config, parse_overrides
from semicp.data import save_kitti_poses
from semicp.geom.se3 import se3_exp
from semicp.register import make_robust_align_fn
from semicp.slam.keyframes import KeyframeStore, keyframe_due, semantic_descriptor
from semicp.slam.loop_closure import (
    LoopVerifier,
    edge_info_from_hessian,
    propose_loop_closures,
)
from semicp.slam.pose_graph import PoseGraph, add_edge, add_pose, optimize_pose_graph
from semicp.slam.submap import build_submap
from semicp.utils import MetricsLogger, PhaseTimer
from semicp.utils.device import require_gpu


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq")
    ap.add_argument("--voxel", type=float, default=0.3)
    ap.add_argument("--out", default="poses_slam.txt")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--n-points", type=int, default=3000)
    ap.add_argument("--loop", action="store_true",
                    help="synthetic: drive a closed loop (tests loop closure)")
    ap.add_argument("--seed", type=int, default=0,
                    help="synthetic: scene/trajectory seed (batch-SLAM "
                         "equivalence tests run one seed per sequence)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="synthetic: inject per-frame odometry drift (m)")
    ap.add_argument("--scan-to-map", action="store_true",
                    help="odometry aligns against the current submap "
                         "instead of the previous scan (BASELINE.json:9)")
    ap.add_argument("--dist", action="store_true",
                    help="config 4 (BASELINE.json:10): shard the submap "
                         "into map blocks over the device mesh, run "
                         "scan-to-map EM with the ring NN + psum'd GN "
                         "(dist/align_dist.py), and finish with a "
                         "distributed Schur-complement map BA "
                         "(slam/map_ba.py). Implies --scan-to-map.")
    ap.add_argument("--gt", default=None,
                    help="KITTI ground-truth poses.txt for ATE/RPE")
    ap.add_argument("--calib", default=None,
                    help="KITTI calib.txt (Tr): move --gt into the "
                         "velodyne frame before evaluation")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-keyframes", type=int, default=256)
    ap.add_argument("--max-edges", type=int, default=1024)
    return ap


def synthetic_loop_frames(n_frames, n_points, closed=True, seed=0):
    """Square-loop trajectory over a structured scene -> frames + GT."""
    from semicp.data import make_scene, render_scan

    rng = np.random.default_rng(seed)
    scene, labels = make_scene(rng, n_points=n_points * 6, extent=30.0)
    labels = labels - 1
    side = n_frames // 4 if closed else n_frames
    turn_frames = max(3, side // 3)
    poses = [np.eye(4, dtype=np.float32)]
    import jax.numpy as jnp

    for i in range(1, n_frames):
        turn = 0.0
        if closed and (i % side) >= side - turn_frames:
            # spread each 90-degree corner over several frames so the
            # per-frame rotation stays trackable by the EM gate
            turn = (np.pi / 2) / turn_frames
        d = np.array([0.8, 0, 0, 0, 0, turn], np.float32)
        poses.append(poses[-1] @ np.asarray(se3_exp(jnp.asarray(d))))
    traj = np.stack(poses)
    frames = [render_scan(rng, scene, labels, p, max_range=28.0,
                          max_points=n_points) for p in traj]
    return frames, traj


def _capture_state(graph, store, anchors, T_now, T_rel_prev, prev_cloud, frame):
    """Full SLAM state -> checkpointable pytree of numpy arrays."""
    kf_clouds = {
        "xyz": np.stack([np.asarray(k.cloud.xyz) for k in store.keyframes]),
        "label": np.stack([np.asarray(k.cloud.label) for k in store.keyframes]),
        "cov6": np.stack([np.asarray(k.cloud.cov6) for k in store.keyframes]),
        "valid": np.stack([np.asarray(k.cloud.valid) for k in store.keyframes]),
        "count": np.asarray([int(k.cloud.count) for k in store.keyframes], np.int32),
    }
    return {
        "graph": {
            "poses": np.asarray(graph.poses), "n_poses": np.asarray(graph.n_poses),
            "edge_i": np.asarray(graph.edge_i), "edge_j": np.asarray(graph.edge_j),
            "edge_z": np.asarray(graph.edge_z),
            "edge_info": np.asarray(graph.edge_info),
            "edge_W": np.asarray(graph.edge_W),
            "n_edges": np.asarray(graph.n_edges),
        },
        "kf_frames": np.asarray([k.frame for k in store.keyframes], np.int32),
        "kf_poses": np.stack([k.pose for k in store.keyframes]),
        "kf_desc": np.stack([k.descriptor for k in store.keyframes]),
        "kf_clouds": kf_clouds,
        "anchor_idx": np.asarray([a for a, _ in anchors], np.int32),
        "anchor_rel": np.stack([r for _, r in anchors]),
        "T_now": np.asarray(T_now), "T_rel_prev": np.asarray(T_rel_prev),
        "prev_cloud": {
            "xyz": np.asarray(prev_cloud.xyz), "label": np.asarray(prev_cloud.label),
            "cov6": np.asarray(prev_cloud.cov6), "valid": np.asarray(prev_cloud.valid),
            "count": np.asarray(prev_cloud.count),
        },
        "frame": np.asarray(frame, np.int32),
    }


def _cloud_from_state(d, i=None):
    import jax.numpy as jnp

    from semicp.cloud import Cloud

    sel = (lambda x: x[i]) if i is not None else (lambda x: x)
    return Cloud(
        xyz=jnp.asarray(sel(d["xyz"])), label=jnp.asarray(sel(d["label"])),
        cov6=jnp.asarray(sel(d["cov6"])), valid=jnp.asarray(sel(d["valid"])),
        count=jnp.asarray(sel(d["count"])),
    )


def _restore_state(state, cfg):
    import jax.numpy as jnp

    g = state["graph"]
    graph = PoseGraph(
        poses=jnp.asarray(g["poses"]), n_poses=jnp.asarray(g["n_poses"]),
        edge_i=jnp.asarray(g["edge_i"]), edge_j=jnp.asarray(g["edge_j"]),
        edge_z=jnp.asarray(g["edge_z"]), edge_info=jnp.asarray(g["edge_info"]),
        edge_W=jnp.asarray(g["edge_W"]),
        n_edges=jnp.asarray(g["n_edges"]),
    )
    store = KeyframeStore()
    for i in range(len(state["kf_frames"])):
        store.add(int(state["kf_frames"][i]), np.asarray(state["kf_poses"][i]),
                  _cloud_from_state(state["kf_clouds"], i),
                  np.asarray(state["kf_desc"][i]))
    anchors = [(int(a), np.asarray(r))
               for a, r in zip(state["anchor_idx"], state["anchor_rel"])]
    prev_cloud = _cloud_from_state(state["prev_cloud"])
    return (graph, store, anchors, np.asarray(state["T_now"], np.float64),
            np.asarray(state["T_rel_prev"], np.float32), prev_cloud,
            int(state["frame"]))


def run_slam(args, cfg: Config):
    timer = PhaseTimer()
    align_fn = make_robust_align_fn(cfg)
    # ONE verification program for the whole run (fixed mesh + fixed
    # padded batch — zero retraces across keyframes, VERDICT r4 weak #2)
    verifier = LoopVerifier(cfg)
    mesh = None
    map_align_fn = align_fn
    if args.dist:
        from semicp.dist import make_mesh
        from semicp.dist.align_dist import make_dist_align_fn

        args.scan_to_map = True
        mesh = make_mesh({cfg.dist.ring_axis: len(jax.devices())})
        map_align_fn = make_dist_align_fn(mesh, cfg)
    ml = MetricsLogger(args.jsonl)

    gt_traj = None
    if args.synthetic:
        frames, gt_traj = synthetic_loop_frames(
            args.synthetic, args.n_points, closed=args.loop,
            seed=getattr(args, "seed", 0))
        frame_iter = iter(frames)

        def next_scan():
            return next(frame_iter, None)
    else:
        from semicp.cli.common import sequence_frames

        if getattr(args, "gt", None):
            from semicp.cli.run_odometry import load_gt_traj

            gt_traj = load_gt_traj(args.gt, getattr(args, "calib", None))
        seq = sequence_frames(args.seq)
        if args.max_frames:
            seq = seq[: args.max_frames]
        it = iter(seq)

        def next_scan():
            item = next(it, None)
            if item is None:
                return None
            return load_scan_np(item[0], item[1], args.voxel)

    graph = PoseGraph.empty(args.max_keyframes, args.max_edges)
    store = KeyframeStore()
    anchors: list[tuple[int, np.ndarray]] = []  # per frame: (kf_idx, T_kf_frame)
    T_now = np.eye(4)
    prev_cloud = None
    T_rel_prev = np.eye(4, dtype=np.float32)
    frame = 0
    n_loop_edges = 0
    submap = None            # (anchor kf index, fused Cloud) for --scan-to-map

    def rebuild_submap():
        """Fuse the last submap_keyframes keyframe clouds into the newest
        keyframe's frame (slam/submap.py). Rebuilt per keyframe; stale
        poses after a PGO correction are refreshed at the next rebuild."""
        poses_cur = np.asarray(graph.poses, np.float64)
        kfs = store.keyframes[-cfg.slam.submap_keyframes:]
        anchor = store[-1].index
        with timer.phase("submap"):
            sm = build_submap(kfs, poses_cur, anchor, cfg,
                              voxel=args.voxel if args.seq else 0.1)
            jax.block_until_ready(sm)
        return anchor, sm

    start_frame = 0
    if args.resume and args.checkpoint_dir:
        from semicp.utils.checkpoint import latest_checkpoint

        step, state = latest_checkpoint(args.checkpoint_dir)
        if state is not None:
            graph, store, anchors, T_now, T_rel_prev, prev_cloud, start_frame = \
                _restore_state(state, cfg)
            frame = start_frame
            if args.scan_to_map and len(store):
                submap = rebuild_submap()
            print(f"resumed at frame {start_frame} "
                  f"({len(store)} keyframes, {int(graph.n_edges)} edges)",
                  file=sys.stderr)

    consumed = 0
    while True:
        scan = next_scan()
        if scan is None:
            break
        if consumed < start_frame:
            consumed += 1
            continue
        consumed += 1
        pts, lab = scan
        with timer.phase("preprocess"):
            cloud = to_device_cloud(pts, lab, cfg)
            jax.block_until_ready(cloud)

        if prev_cloud is None:
            desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
            store.add(frame, T_now, cloud, desc)
            graph = add_pose(graph, T_now.astype(np.float32))
            anchors.append((0, np.eye(4)))
            if args.scan_to_map:
                submap = rebuild_submap()
        else:
            with timer.phase("odometry"):
                if submap is not None:
                    # scan-to-map: align against the fused submap in its
                    # anchor keyframe's frame (denser constraint, less
                    # drift than scan-to-scan; SURVEY.md §3.3)
                    anchor_idx, sm_cloud = submap
                    anchor_pose = np.asarray(graph.poses, np.float64)[anchor_idx]
                    T_pred = T_now @ np.asarray(T_rel_prev, np.float64)
                    T_init = np.linalg.inv(anchor_pose) @ T_pred
                    res = map_align_fn(cloud, sm_cloud,
                                       np.asarray(T_init, np.float32))
                    T_new = anchor_pose @ np.asarray(res.T, np.float64)
                    T_rel = np.linalg.inv(T_now) @ T_new
                else:
                    res = align_fn(cloud, prev_cloud, T_rel_prev)
                    T_rel = np.asarray(res.T, np.float64)
                jax.block_until_ready(res)
            T_rel_prev = T_rel.astype(np.float32)
            if args.drift:
                # simulate biased odometry: a per-frame yaw bias (rad).
                # (A constant translational bias on a closed loop is just
                # a global rotation, which rigid ATE alignment absorbs —
                # yaw bias spirals the estimate and is only fixable by
                # loop closure.)
                import jax.numpy as _jnp

                bias = np.asarray(se3_exp(_jnp.asarray(
                    np.array([0, 0, 0, 0, 0, args.drift], np.float32))), np.float64)
                T_rel = T_rel @ bias
            T_now = T_now @ T_rel
            ml.log(frame=frame, kind="odom", iters=int(res.iterations),
                   cost=float(res.cost), n_corr=float(res.n_corr))

            kf_last = store[-1] if len(store) else None
            poses_now = np.asarray(graph.poses, np.float64)
            last_kf_pose = poses_now[kf_last.index]
            anchors.append((kf_last.index,
                            np.linalg.inv(last_kf_pose) @ T_now))

            if keyframe_due(last_kf_pose, T_now, cfg.slam):
                desc = semantic_descriptor(lab, cfg.cloud.num_classes, pts)
                kf = store.add(frame, T_now, cloud, desc)
                graph = add_pose(graph, T_now.astype(np.float32))
                Z = np.linalg.inv(last_kf_pose) @ T_now
                graph = add_edge(graph, kf_last.index, kf.index,
                                 Z.astype(np.float32),
                                 edge_info_from_hessian(res.H),
                                 H=np.asarray(res.H))
                if args.scan_to_map:
                    submap = rebuild_submap()

                with timer.phase("loop_search"):
                    poses_now = np.asarray(graph.poses, np.float64)
                    cands = propose_loop_closures(store, kf, poses_now, cfg)
                    accepted = []
                    # all candidates verified in ONE batched wide-gate
                    # align on the run-wide prebuilt program
                    for c, ok, Zl, info, Hl in verifier.verify(
                            store, cands[:cfg.slam.lc_max_candidates],
                            kf.index, poses_now):
                        if ok:
                            graph = add_edge(graph, c, kf.index,
                                             Zl.astype(np.float32), info,
                                             H=Hl)
                            accepted.append(c)
                            n_loop_edges += 1
                if accepted:
                    with timer.phase("pgo"):
                        graph = optimize_pose_graph(graph, cfg.slam)
                        jax.block_until_ready(graph)
                    # re-anchor the running pose on the corrected keyframe
                    new_poses = np.asarray(graph.poses, np.float64)
                    T_now = new_poses[kf.index]
                    ml.log(frame=frame, kind="pgo", edges=int(graph.n_edges),
                           loops=len(accepted))

                if args.checkpoint_dir and len(store) % cfg.slam.checkpoint_every == 0:
                    from semicp.utils.checkpoint import save_checkpoint

                    save_checkpoint(
                        args.checkpoint_dir,
                        _capture_state(graph, store, anchors, T_now,
                                       T_rel_prev, cloud, frame + 1),
                        step=len(store))

        prev_cloud = cloud
        frame += 1

    # final PGO + trajectory recomposition against optimized keyframe poses
    if int(graph.n_edges) > 0:
        graph = optimize_pose_graph(graph, cfg.slam)
    final_kf = np.asarray(graph.poses, np.float64)
    ba_stats = None
    if args.dist and len(store) >= 2:
        # config 4's closer: refine keyframe poses against the fused
        # world map with the distributed Schur BA over the mesh
        from semicp.slam.map_ba import refine_keyframes

        with timer.phase("map_ba"):
            final_kf, ba_stats = refine_keyframes(
                store, final_kf, cfg, mesh=mesh,
                voxel=args.voxel if args.seq else 0.1)
        ml.log(frame=frame, kind="map_ba", **ba_stats)
    traj = np.stack([final_kf[a] @ rel for a, rel in anchors])
    save_kitti_poses(args.out, traj)
    ml.close()

    out = {"frames": len(traj), "keyframes": len(store),
           "edges": int(graph.n_edges), "loop_edges": n_loop_edges,
           "out": str(args.out), "timing": timer.summary()}
    if ba_stats is not None:
        out["map_ba"] = ba_stats
    if gt_traj is not None and len(traj) > 2:
        from semicp.eval import ate_rmse, rpe

        gt = gt_traj[: len(traj)]
        out["ate_rmse_m"] = ate_rmse(traj, gt)
        out["rpe_trans_m"], out["rpe_rot_rad"] = rpe(traj, gt)
    return out, timer


def main(argv=None):
    setup_jax()
    require_gpu(allow_cpu=True)
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))
    if not args.synthetic and not args.seq:
        ap.error("--seq or --synthetic required")
    out, timer = run_slam(args, cfg)
    print_result("run_slam", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
