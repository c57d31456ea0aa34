"""Distributed bundle adjustment via Schur complement over mesh collectives.

Reference counterpart: NONE — mandated new capability (BASELINE.json:5:
"distributed bundle adjustment / pose-graph solves via Schur-complement
reduction over device collectives"; SURVEY.md §2.3 "Distributed solver").

Problem: keyframe poses T_i (replicated) + map landmarks p_l (sharded
over the mesh) with observations z_il = T_i^{-1} p_l + noise.

  residual r = T_i^{-1}(p_l) - z_il
  J_pose   = -R_i^T [I | -hat(p_l)]      (3x6, left-mult update on T_i)
  J_lm     =  R_i^T                       (3x3)

The normal system [[Hpp, Hpl],[Hlp, Hll]] has block-diagonal Hll
(3x3 per landmark), so the landmark block eliminates in closed form:

  S = Hpp - sum_l W_l Hll_l^{-1} W_l^T,   W_l = Hpl[:, l]
  g_s = g_p - sum_l W_l Hll_l^{-1} g_l

Distribution: each device holds a landmark shard and ITS observations;
S (6M x 6M) and g_s are psum'd over the mesh axis, the reduced pose
solve runs replicated on every device (deterministic — same values in,
same values out), and landmark back-substitution is local to each
shard. This is the Schur-over-collectives pattern from the north star.

Robustness (same construction as pose_graph.optimize_pose_graph, which
replaced a 1e6-gauge-prior formulation that was ~1e11-conditioned in
f32 and diverged on-chip):
  * pose 0 is gauge-fixed by ELIMINATION (rows/cols zeroed, unit
    diagonal), keeping S well-conditioned;
  * Marquardt-scaled damping S + diag(lam * diag(S) + eps);
  * accept/reject on the (psum'd, replicated) total cost — rejected
    steps raise lam, so the solver cannot diverge on any backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from semicp.geom.se3 import se3_exp, so3_hat


def _linearize(poses, lms, obs_pose, obs_lm, obs_z, obs_w):
    """Per-observation residuals and Jacobian pieces (local shard).

    poses (M,4,4); lms (L,3); obs_* (O,): pose idx, LOCAL landmark idx,
    measured local coords (O,3), weight (O,) with 0 = padding.
    """
    T = poses[obs_pose]                                    # (O,4,4)
    Rt = jnp.swapaxes(T[:, :3, :3], -1, -2)                # R^T
    p = lms[obs_lm]                                        # (O,3)
    r = jnp.einsum("oab,ob->oa", Rt, p - T[:, :3, 3]) - obs_z
    # J_pose = -R^T [I | -hat(p)] -> split blocks
    Jp_t = -Rt                                             # (O,3,3) wrt v
    Jp_r = jnp.einsum("oab,obc->oac", Rt, so3_hat(p))      # (O,3,3) wrt w
    Jp = jnp.concatenate([Jp_t, Jp_r], -1)                 # (O,3,6)
    Jl = Rt                                                # (O,3,3)
    return r, Jp, Jl


def _schur_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w,
                 m: int, axis: str | None, lam):
    """One GN linearization + Schur reduction on the local shard."""
    l_shard = lms.shape[0]
    r, Jp, Jl = _linearize(poses, lms, obs_pose, obs_lm, obs_z, obs_w)
    w = obs_w

    onehot_p = jax.nn.one_hot(obs_pose, m, dtype=jnp.float32)      # (O,M)
    onehot_l = jax.nn.one_hot(obs_lm, l_shard, dtype=jnp.float32)  # (O,L)

    JpTJp = jnp.einsum("o,oai,oaj->oij", w, Jp, Jp)                # (O,6,6)
    Hpp = jnp.einsum("om,oij,on->minj", onehot_p, JpTJp, onehot_p).reshape(6 * m, 6 * m)
    g_p = -jnp.einsum("om,o,oai,oa->mi", onehot_p, w, Jp, r).reshape(6 * m)

    Hll = jnp.einsum("ol,o,oai,oaj->lij", onehot_l, w, Jl, Jl)     # (L,3,3)
    g_l = -jnp.einsum("ol,o,oai,oa->li", onehot_l, w, Jl, r)       # (L,3)
    # W[l] = Hpl block column for landmark l: (L, 6M, 3)
    W = jnp.einsum("om,ol,o,oai,oaj->lmij", onehot_p, onehot_l, w, Jp, Jl)
    W = W.reshape(l_shard, 6 * m, 3)

    # landmark damping keeps Hll SPD (isolated/padded landmarks) AND
    # makes the eliminated block LM-consistent with the pose block
    Hll_damped = Hll + (lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diagonal)(Hll))
                        + 1e-6 * jnp.eye(3))
    Hll_inv = jnp.linalg.inv(Hll_damped)
    S_corr = jnp.einsum("lia,lab,ljb->ij", W, Hll_inv, W)
    g_corr = jnp.einsum("lia,lab,lb->i", W, Hll_inv, g_l)

    S = Hpp - S_corr
    g_s = g_p - g_corr
    if axis is not None:
        S = jax.lax.psum(S, axis)
        g_s = jax.lax.psum(g_s, axis)

    # gauge by ELIMINATION: pose 0's rows/cols zeroed, unit diagonal —
    # not a huge prior (see module docstring); Marquardt-scaled damping
    free = jnp.arange(6 * m) >= 6
    keep = free[:, None] & free[None, :]
    S = jnp.where(keep, S, 0.0)
    g_s = jnp.where(free, g_s, 0.0)
    dS = jnp.diag(S)
    damp = jnp.where(free & (dS > 0.0), lam * dS + 1e-6, 1.0)
    S = S + jnp.diag(damp)
    delta_p = jnp.linalg.solve(S, g_s)                     # (6M,)
    delta_p = jnp.where(free, delta_p, 0.0)

    # back-substitute the local landmark shard: dl = Hll^-1 (g_l - W^T dp)
    Wtd = jnp.einsum("lia,i->la", W, delta_p)
    delta_l = jnp.einsum("lab,lb->la", Hll_inv, g_l - Wtd)
    return delta_p.reshape(m, 6), delta_l


def _ba_cost(poses, lms, obs_pose, obs_lm, obs_z, obs_w, axis):
    """Total weighted squared residual (replicated when psum'd)."""
    r, _, _ = _linearize(poses, lms, obs_pose, obs_lm, obs_z, obs_w)
    c = jnp.sum(obs_w * jnp.sum(r * r, -1))
    if axis is not None:
        c = jax.lax.psum(c, axis)
    return c


def ba_step_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, axis, lam):
    """One damped, accept/reject GN-Schur step.

    Returns (poses, lms, lam) — the step is taken only if the global
    cost decreases (evaluated replicated, so every shard agrees)."""
    dp, dl = _schur_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w,
                          m, axis, lam)
    new_poses = se3_exp(dp) @ poses
    new_lms = lms + dl
    c0 = _ba_cost(poses, lms, obs_pose, obs_lm, obs_z, obs_w, axis)
    c1 = _ba_cost(new_poses, new_lms, obs_pose, obs_lm, obs_z, obs_w, axis)
    ok = jnp.isfinite(c1) & (c1 < c0)
    poses = jnp.where(ok, new_poses, poses)
    lms = jnp.where(ok, new_lms, lms)
    lam = jnp.clip(jnp.where(ok, lam * 0.3, lam * 8.0), 1e-6, 1e4)
    return poses, lms, lam


def _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, axis, iters):
    def body(_, carry):
        poses, lms, lam = carry
        return ba_step_local(poses, lms, obs_pose, obs_lm, obs_z, obs_w,
                             m, axis, lam)

    # normal-equation assembly and the solve need full f32 (DEFAULT
    # matmul precision may use TF32 on the GPU, which stalls LM descent;
    # pose_graph.py:body)
    with jax.default_matmul_precision("highest"):
        poses, lms, _ = jax.lax.fori_loop(
            0, iters, body, (poses, lms, jnp.float32(1e-4)))
    return poses, lms


def make_ba_solver(mesh: Mesh, m: int, iters: int = 5, axis: str = "blocks"):
    """Jitted distributed BA: poses replicated, landmarks + observations
    sharded on `axis`. Observation landmark indices must be LOCAL to the
    shard; padding rows carry obs_w = 0."""

    def local(poses, lms, obs_pose, obs_lm, obs_z, obs_w):
        return _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w,
                        m, axis, iters)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def ba_solve_single(poses, lms, obs_pose, obs_lm, obs_z, obs_w, iters: int = 5):
    """Single-device reference (tests compare the mesh solve against this)."""
    m = poses.shape[0]
    return _ba_loop(poses, lms, obs_pose, obs_lm, obs_z, obs_w, m, None, iters)
