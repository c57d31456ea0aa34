"""NDT baseline — voxel-Gaussian registration.

Reference counterpart: the `pcl::NormalDistributionsTransform`
comparison instantiated in the reference's driver mains (SURVEY.md §2.1
row "Baseline registrations"; Magnusson 2009). Like the GICP ablation
(register/gicp.py) this is a *configuration* of the EM/GN core, not a
second registration engine:

  1. The target cloud is compressed into voxel Gaussians: points are
     Morton-voxel-sorted, segment-reduced into per-voxel (count, mean,
     covariance) — one sort + one segment_sum, fully static shapes —
     and covariances get Magnusson's eigenvalue floor
     (lambda_i >= ratio * lambda_max, keeping each Gaussian usably
     anisotropic without going singular).
  2. Source covariances collapse to ~0 (point-to-distribution: the NDT
     score's Mahalanobis term), or stay GICP-estimated for the D2D
     variant.
  3. `align()` runs as usual: each moved source point associates to its
     nearest voxel Gaussian within the gate (nearest-Gaussian
     association, the standard grid-free NDT variant — PCL probes the
     containing voxel's neighborhood; nearest-mean-in-gate covers the
     same support without voxel hashing), and the M-step minimizes the weighted Mahalanobis cost with
     the voxel covariances — NDT's quadratic score surrogate.

Classic NDT ignores labels (all classes collapse to 0, uniform
semantics); `semantic=True` keeps (voxel, class) as the aggregation key
and the confusion-model weights, giving a semantic-NDT for free.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from semicp.cloud.cloud import Cloud
from semicp.config import Config
from semicp.geom import sym3
from semicp.geom.eig3 import eigh3x3
from semicp.corr.morton import morton_codes
from semicp.register.em_icp import AlignResult, align

FAR = 1.0e6


def _voxel_segments(xyz, label, valid, voxel: float, semantic: bool):
    """Sort by (class?, voxel code), return (order, segment start mask)."""
    code = morton_codes(xyz, valid, voxel)
    if semantic:
        cls = jnp.where(valid, jnp.maximum(label, 0), jnp.int32(1 << 30))
        o1 = jnp.argsort(code, stable=True)
        order = jnp.take(o1, jnp.argsort(jnp.take(cls, o1), stable=True))
    else:
        order = jnp.argsort(code)
    code_s = jnp.take(code, order)
    lab_s = jnp.take(jnp.maximum(label, 0), order)
    val_s = jnp.take(valid, order)
    prev_code = jnp.roll(code_s, 1).at[0].set(-1)
    start = code_s != prev_code
    if semantic:
        start = start | (lab_s != jnp.roll(lab_s, 1).at[0].set(-1))
    return order, start, lab_s, val_s


@functools.partial(
    jax.jit, static_argnames=("voxel", "min_points", "eig_ratio", "semantic"))
def _build_ndt_arrays(xyz, label, valid, voxel, min_points, eig_ratio,
                      semantic: bool):
    n = xyz.shape[1]
    order, start, lab_s, val_s = _voxel_segments(xyz, label, valid,
                                                 float(voxel), semantic)
    xyz_s = jnp.take(xyz, order, axis=1)                     # (3, N)
    seg = jnp.cumsum(start.astype(jnp.int32)) - 1            # (N,)
    w = val_s.astype(jnp.float32)
    x, y, z = xyz_s
    mom = jnp.stack([w, w * x, w * y, w * z,
                     w * x * x, w * y * y, w * z * z,
                     w * x * y, w * x * z, w * y * z])       # (10, N)
    table = jax.vmap(
        lambda m: jax.ops.segment_sum(m, seg, num_segments=n))(mom)
    cnt = table[0]
    safe = jnp.maximum(cnt, 1.0)
    mean = table[1:4] / safe[None, :]                        # (3, V)
    cov6 = jnp.stack([
        table[4] / safe - mean[0] * mean[0],
        table[5] / safe - mean[1] * mean[1],
        table[6] / safe - mean[2] * mean[2],
        table[7] / safe - mean[0] * mean[1],
        table[8] / safe - mean[0] * mean[2],
        table[9] / safe - mean[1] * mean[2],
    ])                                                       # (6, V)
    # Magnusson's regularization, normalized GICP-style: keep each
    # Gaussian's SHAPE (eigenvalues floored at eig_ratio * lambda_max)
    # but rescale lambda_max to 1, matching the (1,1,eps) unit-scale
    # convention of the GICP covariances the EM core's soft weights are
    # calibrated for (physical voxel scale is gauge in the NDT score —
    # a raw ~1e-3 m^2 normal-direction variance makes every Mahalanobis
    # term O(100) and collapses the weights to zero).
    C = sym3.to_matrix(tuple(cov6))                          # (V,3,3)
    wv, V = eigh3x3(C)                                       # (V,3),(V,3,3)
    lmax = jnp.maximum(wv[..., :1], 1e-9)
    wc = jnp.clip(wv / lmax, eig_ratio, 1.0)
    Creg = jnp.einsum("vik,vk,vjk->vij", V, wc, V)
    cov6_r = jnp.stack(sym3.from_matrix(Creg))               # (6, V)
    # voxel label: all points in a (semantic) segment share one label;
    # a plain-NDT segment may mix labels — collapse to 0 either way
    # unless semantic, where the sorted segment is single-label.
    vox_lab = jax.ops.segment_max(
        jnp.where(val_s, lab_s, 0), seg, num_segments=n) if semantic \
        else jnp.zeros((n,), jnp.int32)
    vox_valid = cnt >= min_points
    vox_xyz = jnp.where(vox_valid[None, :], mean, FAR)
    return (vox_xyz, vox_lab.astype(jnp.int32), cov6_r, vox_valid,
            jnp.sum(vox_valid.astype(jnp.int32)))


def build_ndt_cloud(tgt: Cloud, voxel: float = 1.0, min_points: int = 5,
                    eig_ratio: float = 0.01, semantic: bool = False) -> Cloud:
    """Compress a cloud into voxel Gaussians (same padded capacity)."""
    xyz, lab, cov6, valid, count = _build_ndt_arrays(
        tgt.xyz, tgt.label, tgt.valid, voxel, min_points, eig_ratio,
        semantic)
    return Cloud(xyz=xyz, label=jnp.where(valid, lab, -1), cov6=cov6,
                 valid=valid, count=count)


def align_ndt(src: Cloud, tgt: Cloud, cfg: Config | None = None,
              T_init=None, voxel: float = 1.0, semantic: bool = False,
              d2d: bool = False) -> AlignResult:
    """NDT registration: src points against tgt's voxel Gaussians.

    src may be raw (P2D ignores its covariances) unless d2d=True, where
    preprocessed GICP covariances are kept (distribution-to-
    distribution). The correspondence gate should exceed the voxel
    diagonal; the default cfg gate (2 m) covers voxel<=1.15 m.
    """
    cfg = cfg or Config()
    cfg = dataclasses.replace(cfg, em=dataclasses.replace(
        cfg.em, uniform_semantics=not semantic))
    tgt_ndt = build_ndt_cloud(tgt, voxel=voxel, semantic=semantic)
    src_nd = src
    if not d2d:
        # point-to-distribution: combined covariance = voxel cov only
        src_nd = src.replace(cov6=jnp.stack(
            sym3.identity_like(src.xyz[0], scale=1e-6)))
    if not semantic:
        src_nd = src_nd.replace(
            label=jnp.where(src_nd.valid, 0, -1).astype(jnp.int32))
    return align(src_nd, tgt_ndt, cfg, T_init)
