"""Padded planar-SoA semantic point cloud.

Replaces the reference's `SemanticPointCloud<PointT, SemanticT>`
(expected at include/semantic_icp/semantic_point_cloud.h, SURVEY.md §2.1
row "Semantic point cloud"). Two design inversions vs the reference:

1. Labels are *data*, not structure: no per-label sub-clouds or
   per-label kd-trees; per-class behavior comes from masking and
   composite sort keys (semicp/corr/).
2. Planar layout: positions are three (N,) coordinate planes stacked as
   (3, N); covariances are six symmetric-component planes (6, N) in
   semicp.geom.sym3 order. Every per-point plane is a contiguous (N,)
   row, so kernels and XLA fusions read coalesced, unpadded memory along
   N; an (N,3) or (N,3,3) layout strides every plane and pads small
   minor dimensions.

All arrays are padded to a static capacity `n_pad`; `valid` masks the
tail and every reduction must be mask-correct (SURVEY.md §7 hard part #2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Cloud:
    """Planar structure-of-arrays semantic cloud (a JAX pytree).

    xyz:   (3, N_pad) float32 — coordinate planes; padded cols = FAR
    label: (N_pad,)   int32   — semantic class ids; padded = -1
    cov6:  (6, N_pad) float32 — GICP-regularized covariance components
           (sym3 order xx,yy,zz,xy,xz,yz); identity until preprocessed
    valid: (N_pad,)   bool
    count: ()         int32
    """

    xyz: jnp.ndarray
    label: jnp.ndarray
    cov6: jnp.ndarray
    valid: jnp.ndarray
    count: jnp.ndarray
    # static (non-pytree) layout tag: "raw" or "cm" (class-major +
    # Morton-within-class, invalid last — semicp.corr.layout). The cm
    # layout is established once at preprocess time and lets align/cov
    # kernels skip their own sorts; any permutation not via
    # corr.layout.sort_cloud_cm must reset it to "raw".
    layout: str = dataclasses.field(default="raw", metadata=dict(static=True))

    def replace(self, **changes) -> "Cloud":
        return dataclasses.replace(self, **changes)

    @property
    def n_pad(self) -> int:
        return self.xyz.shape[1]

    def points(self) -> np.ndarray:
        """Host-side (count, 3) view for tests/inspection."""
        n = int(self.count)
        return np.asarray(self.xyz).T[:n]


# Padded points are parked far outside any plausible scan so they can never
# be a nearest neighbor even without masking; masking is still applied
# everywhere, this is defense in depth.
FAR = 1.0e6


def pad_to(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    n = arr.shape[0]
    if n > n_pad:
        raise ValueError(f"cloud has {n} points > capacity {n_pad}")
    out = np.full((n_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def make_cloud(xyz: np.ndarray, label: np.ndarray | None = None, n_pad: int | None = None) -> Cloud:
    """Build a padded device Cloud from host (N,3)/(N,) numpy arrays."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if label is None:
        label = np.zeros((n,), np.int32)
    label = np.asarray(label, np.int32)
    if n_pad is None:
        n_pad = max(8, 1 << int(np.ceil(np.log2(max(n, 1)))))
    xyz_p = pad_to(xyz, n_pad, FAR).T.copy()           # (3, N_pad)
    lab_p = pad_to(label, n_pad, -1)
    valid = np.zeros((n_pad,), bool)
    valid[:n] = True
    cov6 = np.zeros((6, n_pad), np.float32)
    cov6[:3] = 1.0                                     # identity components
    return Cloud(
        xyz=jnp.asarray(xyz_p),
        label=jnp.asarray(lab_p),
        cov6=jnp.asarray(cov6),
        valid=jnp.asarray(valid),
        count=jnp.asarray(n, jnp.int32),
    )
