"""Frozen dataclass configuration tree with CLI overrides.

Reference counterpart: argv parsing in driver mains plus hard-coded
constants in `include/semantic_icp/semantic_icp.h` (epsilon, kNN count,
max iterations, max correspondence distance) — see SURVEY.md §5
"Config / flag system". Defaults below mirror SURVEY.md §2.2's reference
values (k_cov≈20, cov_eps≈1e-3, outer iters order 10-40, max corr dist
order of meters).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CloudConfig:
    """Padded SoA cloud representation."""

    n_pad: int = 32768          # padded point capacity per cloud (power of two)
    num_classes: int = 20       # semantic classes after remap (SemanticKITTI train set = 19 + unlabeled)
    voxel_downsample: float = 0.0  # host-side voxel size; 0 = off


@dataclass(frozen=True)
class CovConfig:
    """GICP plane-to-plane per-point covariance estimation (SURVEY.md §2.2 step 1).

    method "radius": masked moment accumulation over a fixed radius
    (cloud/moments.py).
    method "knn": the reference's k-nearest-neighbor semantics
    (corr/bruteforce.knn_self) — used for like-for-like oracle parity.
    Both feed the same (1,1,eps) eigenvalue clamp, which keeps only the
    eigenvector frame, so the two agree on structured geometry.
    """

    method: str = "radius"
    radius: float = 0.0         # neighborhood radius (m); 0 = density-adaptive
                                # (median sampled k-th-NN distance, in-jit)
    k: int = 20                 # kNN size for method="knn"
    eps: float = 1e-3           # smallest-eigenvalue clamp ("plane thickness")


@dataclass(frozen=True)
class CorrConfig:
    """Correspondence engine (replaces per-class kd-trees).

    engine "auto": the block-sparse walk over class-major Morton tiles
    on a GPU (corr/sparse_nn.py), the brute-force XLA search on the CPU
    backend. "sparse" forces the walk (interpret mode on the CPU — how
    the tests run the product path); "xla" forces the brute force.
    """

    engine: str = "auto"        # auto | sparse | xla
    max_dist: float = 2.0       # max correspondence distance gate (m)
    cell: float = 2.0           # Morton quantization cell (locality only, not correctness)


@dataclass(frozen=True)
class EMConfig:
    """Outer EM loop (SURVEY.md §2.2 steps 2-4)."""

    max_iters: int = 30         # outer EM iterations
    trans_eps: float = 1e-4     # convergence: ||log(T_new T_old^-1)|| threshold
    alpha: float = 0.85         # P(observed label correct) — confusion-matrix model
    uniform_semantics: bool = False  # True => plain GICP ablation (uniform class weights)
    retry_overlap_frac: float = 0.8  # warm-start recovery: retry from identity when
                                     # n_corr < frac * min(|src|,|tgt|) (0 disables)


@dataclass(frozen=True)
class GNConfig:
    """Gauss-Newton / LM inner solve (replaces Ceres, SURVEY.md §2 row 'NLLS solver')."""

    max_iters: int = 8          # inner GN iterations per EM step
    lm_lambda0: float = 1e-6    # initial LM damping
    lm_up: float = 10.0
    lm_down: float = 0.3
    step_eps: float = 1e-6      # inner convergence on ||delta||


@dataclass(frozen=True)
class SLAMConfig:
    keyframe_trans: float = 2.0     # m of translation to spawn a keyframe
    keyframe_rot: float = 0.15      # rad of rotation to spawn a keyframe
    submap_keyframes: int = 5       # keyframes aggregated per submap
    lc_min_gap: int = 50            # min keyframe index gap for loop-closure candidates
    lc_max_dist: float = 10.0       # m pose-proximity gate
    lc_desc_thresh: float = 0.25    # semantic-histogram descriptor distance gate
    lc_max_candidates: int = 3      # loop candidates verified per keyframe
    pgo_iters: int = 20             # pose-graph GN iterations
    pgo_huber: float = 1.0          # robust kernel scale
    checkpoint_every: int = 25      # keyframes between checkpoints
    ba_iters: int = 6               # map-BA LM iterations (slam/map_ba.py)
    ba_gate: float = 0.5            # m, keyframe-point -> landmark match gate
    ba_max_landmarks: int = 8192    # cap on fused map landmarks for BA
    ba_obs_per_kf: int = 2048       # cap on observations per keyframe


@dataclass(frozen=True)
class DistConfig:
    mesh_axes: tuple = ("pairs",)   # default 1-D data-parallel mesh over scan pairs
    ring_axis: str = "blocks"       # mesh axis for ring map-block rotation


@dataclass(frozen=True)
class Config:
    cloud: CloudConfig = field(default_factory=CloudConfig)
    cov: CovConfig = field(default_factory=CovConfig)
    corr: CorrConfig = field(default_factory=CorrConfig)
    em: EMConfig = field(default_factory=EMConfig)
    gn: GNConfig = field(default_factory=GNConfig)
    slam: SLAMConfig = field(default_factory=SLAMConfig)
    dist: DistConfig = field(default_factory=DistConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {'em.max_iters': 40, ...} style overrides (the CLI syntax)."""
        cfg = self
        for key, val in dotted.items():
            section, _, leaf = key.partition(".")
            if not leaf:
                raise KeyError(f"override key must be 'section.field', got {key!r}")
            sub = getattr(cfg, section)
            cur = getattr(sub, leaf)  # raises on unknown field
            if cur is not None and not isinstance(val, type(cur)):
                val = type(cur)(val)
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **{leaf: val})})
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def default_config() -> Config:
    return Config()


def parse_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse `--em.max_iters=40` style CLI flags into an override dict."""
    out: dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            continue
        key, _, val = arg[2:].partition("=")
        if "." not in key:
            continue
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            out[key] = {"true": True, "false": False}.get(val.lower(), val)
    return out
