"""Distributed scan-to-map EM alignment — config 4's compute core.

Reference counterpart: NONE — the reference holds one scan pair in one
address space (SURVEY.md §2.3). Here ONE alignment is spread over the
mesh: source-scan points are sharded along `axis`, the target map lives
as mesh-sharded blocks, and each EM iteration runs

  E-step  ring NN sweep (dist/ring_corr.py — the block-sparse walk per
          block, ppermute rotation) + local weight/reduce
  M-step  Gauss-Newton whose 6x6 normal equations are psum'd over the
          axis (gauss_newton.gn_solve(axis_name=...)), solved replicated

inside a single shard_map + lax.while_loop program. Every scalar the
convergence check reads (step norm, iteration count) is derived from
psum'd values, so all devices run identical trip counts and the result
is replicated. Structurally this is the same program as the single-chip
EM (register/em_icp.py) with two collectives inserted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from semicp.cloud.cloud import Cloud
from semicp.config import Config
from semicp.dist.ring_corr import prepare_ring_block, ring_sweep
from semicp.geom import sym3
from semicp.geom.se3 import se3_inverse, se3_log
from semicp.register.em_icp import AlignResult, resolve_engine
from semicp.register.estep import estep_reduce
from semicp.register.gauss_newton import apply_T_planar, gn_solve


def _local_log_sem(label, num_classes: int, alpha: float, uniform: bool):
    """(K, Qs) semantic log-prior for the local source shard."""
    if uniform:
        return jnp.zeros((num_classes,) + label.shape, jnp.float32)
    classes = jnp.arange(num_classes, dtype=jnp.int32)[:, None]
    match = label[None, :] == classes
    return jnp.where(
        match,
        jnp.log(alpha),
        jnp.log((1.0 - alpha) / max(num_classes - 1, 1)),
    ).astype(jnp.float32)


def _dist_align_local(src_xyz, src_label, src_cov6, src_valid,
                      blk_xyz, blk_label, blk_valid, blk_cov6, T0,
                      *, cfg: Config, axis: str, engine: str):
    """Per-device body: full EM with ring E-step and psum'd GN."""
    K = cfg.cloud.num_classes
    blk0 = prepare_ring_block(blk_xyz, blk_label, blk_valid, blk_cov6,
                              K, engine, cell=cfg.corr.cell)
    log_sem = _local_log_sem(src_label, K, cfg.em.alpha,
                             cfg.em.uniform_semantics)
    src_planes = tuple(src_xyz)

    def cond(carry):
        T, it, step, cost, n_corr, H = carry
        return (it < cfg.em.max_iters) & (step > cfg.em.trans_eps)

    def body(carry):
        T, it, _step, _cost, _n, _H = carry
        moved = apply_T_planar(T, src_planes)
        moved_arr = jnp.stack(moved)
        nn_d2, attrs = ring_sweep(moved_arr, blk0, K, axis, engine,
                                  gate=cfg.corr.max_dist, q_valid=src_valid)
        rc = jnp.stack(sym3.rotate(T[:3, :3], tuple(src_cov6)))
        a6_arr, b3_arr, c, wsum = estep_reduce(
            nn_d2, attrs, rc, moved_arr, log_sem, src_valid,
            cfg.corr.max_dist ** 2)
        a6 = tuple(a6_arr[i] for i in range(6))
        b3 = tuple(b3_arr[i] for i in range(3))
        T_new, cost, _, H = gn_solve(T, src_planes, a6, b3, c, cfg.gn,
                                     axis_name=axis)
        step = jnp.linalg.norm(se3_log(T_new @ se3_inverse(T)))
        n_corr = jax.lax.psum(jnp.sum(wsum), axis)
        return (T_new, it + 1, step, cost, n_corr, H)

    init = (
        T0,
        jnp.int32(0),
        jnp.float32(jnp.inf),
        jnp.float32(0.0),
        jnp.float32(0.0),
        jnp.zeros((6, 6), jnp.float32),
    )
    with jax.default_matmul_precision("highest"):
        T, it, step, cost, n_corr, H = jax.lax.while_loop(cond, body, init)
    return T, it, step <= cfg.em.trans_eps, cost, n_corr, H


def make_dist_align_fn(mesh: Mesh, cfg: Config, axis: str | None = None,
                       engine: str | None = None):
    """Jitted distributed align(src, tgt, T0) -> AlignResult.

    src: the incoming scan, points sharded over `axis`; tgt: the map
    (e.g. a fused submap, slam/submap.py), sharded into blocks over the
    same axis. Both clouds' n_pad must divide the axis size. The result
    is replicated and drop-in compatible with register.make_align_fn.
    """
    axis = axis or cfg.dist.ring_axis
    engine = resolve_engine(engine or cfg.corr.engine)

    pt = P(None, axis)
    pl_ = P(axis)
    fn = jax.shard_map(
        functools.partial(_dist_align_local, cfg=cfg, axis=axis,
                          engine=engine),
        mesh=mesh,
        in_specs=(pt, pl_, pt, pl_, pt, pl_, pl_, pt, P()),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    jitted = jax.jit(fn)

    def align(src: Cloud, tgt: Cloud, T0=None) -> AlignResult:
        if T0 is None:
            T0 = jnp.eye(4, dtype=jnp.float32)
        T0 = jnp.asarray(T0, jnp.float32)
        T, it, conv, cost, n_corr, H = jitted(
            src.xyz, src.label, src.cov6, src.valid,
            tgt.xyz, tgt.label, tgt.valid, tgt.cov6, T0)
        return AlignResult(T=T, iterations=it, converged=conv,
                           cost=cost, n_corr=n_corr, H=H)

    return align
