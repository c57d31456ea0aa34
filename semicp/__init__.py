"""semicp — semantic registration & SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
kxhit/semantic-icp (Semantic Iterative Closest Point through
Expectation-Maximization, Parkison et al., BMVC 2018; see SURVEY.md).

Layer map (bottom-up):
  geom/      SE(3) Lie group math, closed-form 3x3 symmetric eigensolver
  cloud/     padded SoA point-cloud containers + GICP covariance estimation
  corr/      class-major Morton layout + block-sparse NN (Pallas Triton)
  register/  EM semantic registration core (E-step weights, GN/LM M-step)
  oracle/    CPU-numpy reference implementation (parity oracle + baseline)
  data/      KITTI / SemanticKITTI ingestion, synthetic generators
  eval/      ATE / RPE trajectory evaluation
  slam/      keyframes, loop closure, pose-graph optimization, Schur BA
  dist/      device mesh, scan-pair batching, ring correspondence
  cli/       run_pair / run_odometry / run_slam / bench drivers
"""

__version__ = "0.1.0"

import jax as _jax

# On the GPU, DEFAULT f32 matmul precision may run products in TF32
# (about 10 mantissa bits). Every matmul in this engine is small geometry
# / normal-equation work (4x4 pose composition, 6x6 GN solves, pose-graph
# Hessian assembly, the distance expansion x^2+y^2-2xy) where that
# truncation is a *correctness* bug: LM steps stop being descent
# directions and the optimizer stalls far above the reachable cost. The
# throughput-critical paths either pin precision explicitly
# (corr/bruteforce.py, cloud/moments.py) or compute in plain f32 FMAs
# (corr/sparse_nn.py), so full f32 everywhere is the safe default.
_jax.config.update("jax_default_matmul_precision", "highest")

from semicp.config import Config, default_config  # noqa: F401, E402
from semicp.cloud import Cloud, make_cloud, preprocess_cloud  # noqa: F401, E402
from semicp.register import align, make_align_fn  # noqa: F401, E402
