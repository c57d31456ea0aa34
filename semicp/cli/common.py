"""Shared CLI plumbing: scan loading (KITTI or synthetic), run dirs."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


# the persistent compilation cache's home when JAX_COMPILATION_CACHE_DIR
# is unset: one fixed directory in the checkout (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def setup_jax() -> None:
    """Enable the persistent XLA compilation cache for this process.

    A scan-scale align program takes tens of seconds to compile; the
    cache amortizes it across invocations at identical shapes. Safe to
    call more than once.
    """
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    # cache every program: CLI processes are short-lived, so even
    # fast-compiling helper programs are worth persisting
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


from semicp.config import Config
from semicp.cloud import Cloud, make_cloud, preprocess_cloud
from semicp.data import (
    load_semantickitti_labels,
    load_velodyne_bin,
    remap_semantickitti,
)
from semicp.data.kitti import voxel_downsample


def load_scan_np(bin_path, label_path=None, voxel: float = 0.0):
    """Load one scan (+ optional SemanticKITTI labels) as numpy.

    Dispatches on extension: `.pcd` files (the reference's on-disk
    format, optionally with an embedded XYZL label field) go through
    semicp.data.pcd; KITTI `.bin` scans use the native C++ loader
    (semicp.data.native) when available — parse + remap + voxel
    downsample without intermediate copies — with numpy fallbacks.
    """
    from semicp.data import native
    from semicp.data.kitti import _REMAP_LUT

    if Path(bin_path).suffix.lower() == ".pcd":
        from semicp.data.pcd import load_pcd

        pts, lab = load_pcd(bin_path)
        if label_path is not None:
            raw, _ = load_semantickitti_labels(label_path)
            lab = remap_semantickitti(raw)
            if len(lab) != len(pts):
                raise ValueError(
                    f"scan/label length mismatch: {len(pts)} vs {len(lab)}")
        elif lab is None:
            lab = np.zeros(len(pts), np.int32)
        if voxel > 0:
            pts, lab = voxel_downsample(pts, lab, voxel)
        return pts.astype(np.float32), lab.astype(np.int32)

    if native.native_available():
        xyz, _ = native.load_bin_planar(bin_path)
        n = xyz.shape[1]
        if label_path is not None:
            lab = native.load_labels_remapped(label_path, _REMAP_LUT, n)
            if len(lab) != n:
                raise ValueError(f"scan/label length mismatch: {n} vs {len(lab)}")
        else:
            lab = np.zeros(n, np.int32)
        if voxel > 0:
            xyz, lab = native.voxel_downsample_planar(xyz, lab, voxel)
        return xyz.T.copy(), lab

    pts = load_velodyne_bin(bin_path)[:, :3]
    if label_path is not None:
        raw, _ = load_semantickitti_labels(label_path)
        lab = remap_semantickitti(raw)
        if len(lab) != len(pts):
            raise ValueError(f"scan/label length mismatch: {len(pts)} vs {len(lab)}")
    else:
        lab = np.zeros(len(pts), np.int32)
    if voxel > 0:
        pts, lab = voxel_downsample(pts, lab, voxel)
    return pts.astype(np.float32), lab.astype(np.int32)


def to_device_cloud(pts, lab, cfg: Config) -> Cloud:
    """Pad, upload, and preprocess a scan with the FULL config.

    The full config puts the cloud in canonical class-major Morton
    layout (corr.layout), which selects the sparse moments walk here
    and lets align skip its own per-align sort — the product path every
    CLI driver should take (a bare cfg.cov would fall back to the dense
    O(N^2) sweep + raw layout).

    Labels are validated against cfg.cloud.num_classes here: the KITTI
    path remaps into [0, K), but `.pcd` XYZL files carry arbitrary
    uint32 labels, and an out-of-range label would silently corrupt the
    class-tiled kernels' per-tile class ranges (r3 advisor, medium).
    """
    lab = np.asarray(lab)
    if lab.size and int(lab.max()) >= cfg.cloud.num_classes:
        raise ValueError(
            f"label {int(lab.max())} >= cloud.num_classes="
            f"{cfg.cloud.num_classes}; remap labels into [0, K) first "
            "(raw un-remapped SemanticKITTI ids in a .pcd file?)")
    c = make_cloud(pts, lab, n_pad=cfg.cloud.n_pad)
    return preprocess_cloud(c, cfg)


def sequence_frames(seq_dir: str | Path):
    """List (bin, label|None) pairs for a KITTI sequence directory layout:
    <seq>/velodyne/*.bin and optional <seq>/labels/*.label."""
    seq = Path(seq_dir)
    bins = sorted((seq / "velodyne").glob("*.bin"))
    labels_dir = seq / "labels"
    out = []
    for b in bins:
        lbl = labels_dir / (b.stem + ".label")
        out.append((b, lbl if lbl.exists() else None))
    return out


def init_run_dir(path: str | Path | None, cfg: Config):
    """Create a run directory with the serialized config (reproducibility)."""
    if path is None:
        return None
    run = Path(path)
    run.mkdir(parents=True, exist_ok=True)
    (run / "config.json").write_text(cfg.to_json())
    return run


def pose_to_json(T) -> list:
    return np.asarray(T, np.float64).reshape(-1).tolist()


def print_result(tag: str, result_dict: dict):
    print(json.dumps({"tag": tag, **result_dict}))
