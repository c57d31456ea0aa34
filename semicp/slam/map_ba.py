"""Global map refinement: keyframe poses + map landmarks via Schur BA.

Reference counterpart: NONE — mandated new capability (BASELINE.json:10
"full-sequence SLAM with sharded map blocks and distributed
Schur-complement BA"; SURVEY.md §2.3 "Distributed solver"). This module
is the host-side assembly around slam/schur.py's distributed solver:

  1. landmarks  = the fused keyframe map, voxel-downsampled in WORLD
                  frame at current pose estimates (the sharded map
                  blocks of config 4 — each mesh device owns L/D of
                  them);
  2. observations = per-keyframe semantic correspondences: every
                  keyframe point is matched to its same-class nearest
                  landmark within a gate (corr/bruteforce.class_nn);
                  the measurement z_il is the point's
                  keyframe-LOCAL coordinates;
  3. solve      = slam/schur.make_ba_solver over the mesh (landmarks +
                  their observations sharded on the ring axis, pose
                  system psum-reduced and solved replicated), or
                  schur.ba_solve_single off-mesh — both run the
                  identical math, which the tests assert.

The refined keyframe poses feed the driver's trajectory recomposition
(cli/run_slam.py --dist).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from semicp.corr.bruteforce import class_nn
from semicp.data.kitti import voxel_downsample
from semicp.slam.schur import ba_solve_single, make_ba_solver

FAR = 1.0e6


def build_landmarks(store, poses: np.ndarray, voxel: float,
                    max_landmarks: int, n_shards: int, seed: int = 0):
    """Fuse keyframe clouds into world-frame landmarks.

    Returns (lms (L,3) f32, lab (L,) i32, valid (L,) bool) with L padded
    to a multiple of n_shards; padded rows sit at FAR so no real point
    matches them.
    """
    pts_all, lab_all = [], []
    for kf in store.keyframes:
        T = poses[kf.index].astype(np.float64)
        n = int(kf.cloud.count)
        pts = np.asarray(kf.cloud.xyz).T[:n].astype(np.float64)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        lab_all.append(np.asarray(kf.cloud.label)[:n])
    pts = np.concatenate(pts_all).astype(np.float32)
    lab = np.concatenate(lab_all).astype(np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    if len(pts) > max_landmarks:
        sel = np.random.default_rng(seed).permutation(len(pts))[:max_landmarks]
        pts, lab = pts[sel], lab[sel]
    L = len(pts)
    L_pad = int(np.ceil(L / n_shards)) * n_shards
    lms = np.full((L_pad, 3), FAR, np.float32)
    labs = np.full((L_pad,), -1, np.int32)
    valid = np.zeros((L_pad,), bool)
    lms[:L], labs[:L], valid[:L] = pts, lab, True
    return lms, labs, valid


def collect_observations(store, poses: np.ndarray, lms, lab, lm_valid,
                         gate: float, num_classes: int,
                         max_obs_per_kf: int, seed: int = 0):
    """Match every keyframe point to its same-class NN landmark in gate.

    Returns (obs_pose (O,), obs_lm (O,) GLOBAL landmark ids, obs_z (O,3)
    keyframe-local measurements, obs_w (O,)).
    """
    rng = np.random.default_rng(seed)
    lms_pl = jnp.asarray(lms.T)                            # (3, L)
    lab_j = jnp.asarray(np.maximum(lab, 0))
    val_j = jnp.asarray(lm_valid)
    nn = jax.jit(lambda q: class_nn(lms_pl, lab_j, val_j, q, num_classes))

    op, ol, oz = [], [], []
    for kf in store.keyframes:
        T = poses[kf.index].astype(np.float64)
        n = int(kf.cloud.count)
        local = np.asarray(kf.cloud.xyz).T[:n].astype(np.float64)
        klab = np.asarray(kf.cloud.label)[:n]
        world = (local @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        # queries keep the cloud's padded capacity; pad rows sit at FAR
        qpl = np.full_like(np.asarray(kf.cloud.xyz), FAR)
        qpl[:, :n] = world.T
        idx, d2 = map(np.asarray, nn(jnp.asarray(qpl)))    # (K, Npad)
        rows = np.maximum(klab, 0)
        cols = np.arange(n)
        my_idx = idx[rows, cols]
        my_d2 = d2[rows, cols]
        ok = (my_d2 <= gate * gate) & (klab >= 0)
        sel = np.nonzero(ok)[0]
        if len(sel) > max_obs_per_kf:
            sel = rng.permutation(sel)[:max_obs_per_kf]
        op.append(np.full(len(sel), kf.index, np.int32))
        ol.append(my_idx[sel].astype(np.int32))
        oz.append(local[sel].astype(np.float32))
    obs_pose = np.concatenate(op) if op else np.zeros(0, np.int32)
    obs_lm = np.concatenate(ol) if ol else np.zeros(0, np.int32)
    obs_z = np.concatenate(oz) if oz else np.zeros((0, 3), np.float32)
    return obs_pose, obs_lm, obs_z, np.ones(len(obs_pose), np.float32)


def shard_observations(obs_pose, obs_lm, obs_z, obs_w, L: int, n_shards: int):
    """Group observations by landmark shard (landmark l lives on device
    l // (L/n_shards)), pad each group to the max, localize lm indices.

    Returns flattened (obs_pose, obs_lm_local, obs_z, obs_w) ready for
    make_ba_solver's sharded in_specs."""
    per = L // n_shards
    dev = obs_lm // per
    groups = [np.nonzero(dev == d)[0] for d in range(n_shards)]
    omax = max([len(g) for g in groups] + [1])
    OP = np.zeros((n_shards, omax), np.int32)
    OL = np.zeros((n_shards, omax), np.int32)
    OZ = np.zeros((n_shards, omax, 3), np.float32)
    OW = np.zeros((n_shards, omax), np.float32)
    for d, g in enumerate(groups):
        n = len(g)
        OP[d, :n] = obs_pose[g]
        OL[d, :n] = obs_lm[g] - d * per
        OZ[d, :n] = obs_z[g]
        OW[d, :n] = obs_w[g]
    return (OP.reshape(-1), OL.reshape(-1), OZ.reshape(-1, 3),
            OW.reshape(-1))


def refine_keyframes(store, poses: np.ndarray, cfg, mesh: Mesh | None = None,
                     voxel: float = 0.3):
    """One global BA refinement pass. Returns ((M,4,4) refined keyframe
    poses, stats dict); poses are unchanged rows beyond the keyframe
    count. mesh=None solves single-device (the reference the distributed
    path must match)."""
    M = len(store.keyframes)
    if M < 2:
        return poses, {"landmarks": 0, "observations": 0}
    n_shards = mesh.devices.size if mesh is not None else 1
    s = cfg.slam
    lms, lab, lm_valid = build_landmarks(
        store, poses, voxel, s.ba_max_landmarks, n_shards)
    obs_pose, obs_lm, obs_z, obs_w = collect_observations(
        store, poses, lms, lab, lm_valid, s.ba_gate, cfg.cloud.num_classes,
        s.ba_obs_per_kf)
    stats = {"landmarks": int(lm_valid.sum()), "observations": len(obs_pose)}
    if len(obs_pose) < 6 * M:
        return poses, stats
    kf_ids = np.asarray([kf.index for kf in store.keyframes], np.int32)
    p0 = poses[kf_ids].astype(np.float32)
    # BA pose indices are keyframe-store positions (0..M-1)
    remap = np.zeros(int(kf_ids.max()) + 1, np.int32)
    remap[kf_ids] = np.arange(M, dtype=np.int32)
    obs_pose = remap[obs_pose]

    if mesh is not None:
        op, ol, oz, ow = shard_observations(
            obs_pose, obs_lm, obs_z, obs_w, len(lms), n_shards)
        solver = make_ba_solver(mesh, m=M, iters=s.ba_iters,
                                axis=cfg.dist.ring_axis)
        new_p, _ = solver(jnp.asarray(p0), jnp.asarray(lms),
                          jnp.asarray(op), jnp.asarray(ol),
                          jnp.asarray(oz), jnp.asarray(ow))
    else:
        new_p, _ = ba_solve_single(
            jnp.asarray(p0), jnp.asarray(lms), jnp.asarray(obs_pose),
            jnp.asarray(obs_lm), jnp.asarray(obs_z), jnp.asarray(obs_w),
            iters=s.ba_iters)
    out = poses.copy()
    out[kf_ids] = np.asarray(new_p, poses.dtype)
    return out, stats
