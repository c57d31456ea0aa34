"""Frame-to-frame odometry driver — config 2 (BASELINE.json:8).

Reference counterpart: the KITTI sequence driver (SURVEY.md §2.1 row
"Sequence odometry driver", §3.2): loop over scans, align consecutive
pairs with the previous relative pose as warm start, chain transforms,
write KITTI-format poses.txt. Differences by design: each scan is
preprocessed once and reused as source then target (the reference
rebuilds trees/covariances every frame), and the poses file is
append-only so --resume re-enters at the last written frame (the
reference's crude-but-real resume point, SURVEY.md §5).

Usage:
  python -m semicp.cli.run_odometry --seq /path/to/sequence [--voxel 0.3]
      [--out poses.txt] [--jsonl metrics.jsonl] [--resume] [--max-frames N]
  python -m semicp.cli.run_odometry --synthetic 60 [--n-points 4000]
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
from semicp.utils import MetricsLogger, PhaseTimer
from semicp.utils.device import require_gpu


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", help="KITTI sequence dir (velodyne/ + optional labels/)")
    ap.add_argument("--voxel", type=float, default=0.3)
    ap.add_argument("--out", default="poses.txt")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames")
    ap.add_argument("--n-points", type=int, default=4000)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="scan-ingest pipeline depth (slam/pipeline.py): "
                         "host IO runs this many scans ahead and device "
                         "preprocess is dispatched async; 0 = serial "
                         "(identical results either way)")
    ap.add_argument("--gt", default=None,
                    help="KITTI ground-truth poses.txt: evaluate ATE/RPE "
                         "against it (the reference workflow's offline "
                         "devkit/evo step, built in)")
    ap.add_argument("--calib", default=None,
                    help="KITTI calib.txt with a Tr line: --gt poses are "
                         "camera-frame; Tr^-1 P Tr moves them into the "
                         "velodyne frame this driver estimates in")
    return ap


def load_gt_traj(gt_path, calib_path=None):
    """Ground-truth trajectory in the velodyne frame, (N, 4, 4)."""
    from semicp.data import load_kitti_calib, load_kitti_poses

    gt = load_kitti_poses(gt_path)
    if calib_path:
        Tr = load_kitti_calib(calib_path)
        gt = np.linalg.inv(Tr)[None] @ gt @ Tr[None]
    return gt


def synthetic_frames(n_frames, n_points, seed=0):
    from semicp.data import make_scene, make_trajectory, render_scan

    rng = np.random.default_rng(seed)
    scene, labels = make_scene(rng, n_points=n_points * 4, extent=30.0)
    labels = labels - 1
    traj = make_trajectory(n_frames, step=0.6, turn=0.05, seed=seed)
    for pose in traj:
        yield render_scan(rng, scene, labels, pose, max_range=25.0,
                          max_points=n_points), traj


def run_odometry(args, cfg: Config):
    timer = PhaseTimer()
    from semicp.register.em_icp import PipelinedAligner

    aligner = PipelinedAligner(cfg)

    poses = [np.eye(4)]
    gt_traj = None
    out_path = Path(args.out)

    if args.synthetic:
        frames = []
        for (pts, lab), traj in synthetic_frames(args.synthetic, args.n_points):
            frames.append((pts, lab))
            gt_traj = traj
        loader = iter(frames)

        def next_scan():
            return next(loader, None)
    else:
        from semicp.cli.common import sequence_frames

        seq = sequence_frames(args.seq)
        if args.max_frames:
            seq = seq[: args.max_frames]
        it = iter(seq)

        def next_scan():
            item = next(it, None)
            if item is None:
                return None
            b, l = item
            return load_scan_np(b, l, args.voxel)

        if getattr(args, "gt", None):
            gt_traj = load_gt_traj(args.gt, getattr(args, "calib", None))

    start_frame = 0
    if args.resume and out_path.exists():
        existing = np.loadtxt(out_path).reshape(-1, 3, 4)
        poses = [np.vstack([p, [0, 0, 0, 1]]) for p in existing]
        start_frame = len(poses) - 1
        print(f"resuming at frame {start_frame}", file=sys.stderr)

    ml = MetricsLogger(args.jsonl)
    from semicp.slam.pipeline import ScanPrefetcher

    pf = ScanPrefetcher(next_scan, depth=max(getattr(args, "prefetch", 0), 0))
    serial = getattr(args, "prefetch", 0) == 0
    prev_cloud = None
    pending_meta = None   # (frame, n_points) of the in-flight pair
    frame = 0

    def chain(res, meta):
        f, n_pts = meta
        T_rel = np.asarray(res.T, np.float64)
        poses.append(poses[-1] @ T_rel)
        ml.log(frame=f, iterations=int(res.iterations),
               converged=bool(res.converged), cost=float(res.cost),
               n_corr=float(res.n_corr), n_points=n_pts)
        save_kitti_poses(out_path, np.asarray(poses))

    while True:
        scan = pf.get()
        if scan is None:
            break
        pts, lab = scan
        if frame < start_frame:
            frame += 1
            continue
        with timer.phase("preprocess"):
            # async dispatch: XLA queues the preprocess program; the
            # align below queues behind it and the host moves on to the
            # prefetched next scan (slam/pipeline.py stage contract)
            cloud = to_device_cloud(pts, lab, cfg)
            if serial:
                jax.block_until_ready(cloud)
        if prev_cloud is not None:
            with timer.phase("align"):
                # dispatch align(t); the aligner warm-starts from the
                # previous result's DEVICE pose (constant-velocity
                # model) and hands back frame t-1's RESOLVED result —
                # its deferred health check never stalls a dispatch
                # (em_icp.PipelinedAligner)
                res_prev = aligner.submit(cloud, prev_cloud)
            if res_prev is not None:
                chain(res_prev, pending_meta)
            pending_meta = (frame, len(pts))
        prev_cloud = cloud
        frame += 1

    with timer.phase("align"):
        res_last = aligner.flush()
    if res_last is not None:
        chain(res_last, pending_meta)

    ml.close()
    out = {"frames": len(poses), "out": str(out_path), "timing": timer.summary()}
    if gt_traj is not None and len(poses) > 2:
        from semicp.eval import ate_rmse, rpe

        est = np.asarray(poses)
        gt = gt_traj[: len(poses)]
        out["ate_rmse_m"] = ate_rmse(est, gt)
        out["rpe_trans_m"], out["rpe_rot_rad"] = rpe(est, gt)
    return out, timer


def main(argv=None):
    setup_jax()
    require_gpu(allow_cpu=True)
    ap = build_parser()
    args, extra = ap.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config().override(parse_overrides(extra))
    if not args.synthetic and not args.seq:
        ap.error("--seq or --synthetic required")
    out, timer = run_odometry(args, cfg)
    print_result("run_odometry", out)
    print(timer.table(), file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
