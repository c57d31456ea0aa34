"""Ring correspondence: points-sharded NN over mesh-sharded map blocks.

Reference counterpart: NONE — the reference holds one scan pair in RAM
(SURVEY.md §2.3 row "Sequence/context parallel"). This is the
registration-domain isomorph of ring attention: the map lives sharded
as blocks across devices, each device holds a shard of query (source)
points, and blocks rotate around the mesh with `jax.lax.ppermute` so
every query shard sees every map block. Blockwise min-merging keeps
peak memory at (query shard + one map block), exactly like blockwise
softmax accumulation in ring attention (SURVEY.md §5 "Long-context /
sequence parallelism").

Engines per ring step (em_icp.resolve_engine):
  sparse — the block-sparse walk (corr/sparse_nn.py). Each shard sorts
           its block into the canonical class-major Morton layout ONCE
           before the ring spins and packs the slab + per-tile AABB/class
           metadata ((n_tt, 3) x2 + (n_tt,) x2 — a few KB), which rotate
           together. Map blocks are where N is largest, so the
           O(N x tiles-in-gate) prune matters most here.
  xla    — the brute-force search (the CPU engine).

Used for scan-to-map correspondence when the map exceeds one device
(configs 4-5, BASELINE.json:10-11).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from semicp.corr.sparse_nn import (
    NATTR,
    class_nn_attrs_sparse,
    class_nn_attrs_xla,
    pack_sparse,
)
from semicp.register.em_icp import resolve_engine

INF = 3.0e37


def _merge(best, new):
    """Elementwise min-merge of (d2 (K,Q), attrs (K,16,Q)) pairs."""
    d2_b, at_b = best
    d2_n, at_n = new
    take = d2_n < d2_b
    return (jnp.where(take, d2_n, d2_b),
            jnp.where(take[:, None, :], at_n, at_b))


def prepare_ring_block(blk_xyz, blk_label, blk_valid, blk_cov6,
                       num_classes: int, engine: str, cell: float = 1.0):
    """Loop-invariant per-shard block prep (inside shard_map).

    The block is sorted ONCE and the packed slab (+ tile metadata) is
    what rotates; an EM loop calling `ring_sweep` each iteration pays
    this only once. After a full sweep (n_dev rotations) every device
    holds its original block again, so the prepared block is reusable
    across sweeps."""
    if engine == "sparse":
        from semicp.corr.layout import class_morton_order

        order = class_morton_order(blk_xyz, blk_label, blk_valid,
                                   num_classes, cell)
        return pack_sparse(jnp.take(blk_xyz, order, axis=1),
                           jnp.take(blk_label, order),
                           jnp.take(blk_valid, order),
                           jnp.take(blk_cov6, order, axis=1), num_classes)
    return (blk_xyz, blk_label, blk_valid, blk_cov6)


def ring_sweep(q_xyz, blk0, num_classes: int, axis: str, engine: str,
               gate=2.0, q_valid=None):
    """One full ring rotation: my query shard vs every map block.

    blk0 comes from `prepare_ring_block`. The map block rotates
    `axis`-size times; comms (ppermute) overlap the next step's compute
    under XLA's scheduler. Returns the global per-class NN of my query
    shard against the WHOLE map: (d2 (K, Qs), attrs (K, 16, Qs)).

    gate/q_valid are used by the sparse engine only (AABB pruning —
    beyond-gate entries may come back INF, which the E-step rejects
    anyway; the xla engine stays exact everywhere)."""
    n_dev = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    if engine == "sparse":
        qv = (jnp.ones(q_xyz.shape[1], bool)
              if q_valid is None else q_valid)

        def nn(blk):
            return class_nn_attrs_sparse(blk, q_xyz, qv,
                                         num_classes=num_classes, gate=gate)
    else:
        def nn(blk):
            bx, blab, bval, bcov = blk
            return class_nn_attrs_xla(bx, blab, bval, bcov, q_xyz,
                                      num_classes)

    def step(carry, _):
        best, blk = carry
        best = _merge(best, nn(blk))
        blk = jax.tree.map(lambda x: jax.lax.ppermute(x, axis, perm), blk)
        return (best, blk), None

    k = num_classes
    qs = q_xyz.shape[1]
    init_best = (jnp.full((k, qs), INF),
                 jnp.zeros((k, NATTR, qs), jnp.float32))
    (best, _), _ = jax.lax.scan(step, (init_best, blk0), None, length=n_dev)
    return best


def ring_class_nn_local(q_xyz, blk_xyz, blk_label, blk_valid, blk_cov6,
                        num_classes: int, axis: str, engine: str,
                        gate: float = 2.0):
    """Per-device body: prepare my block, then one full ring sweep."""
    blk0 = prepare_ring_block(blk_xyz, blk_label, blk_valid, blk_cov6,
                              num_classes, engine)
    return ring_sweep(q_xyz, blk0, num_classes, axis, engine, gate=gate)


def make_ring_nn(mesh: Mesh, num_classes: int, axis: str = "blocks",
                 engine: str = "auto", gate: float = 2.0):
    """Jitted ring NN: queries sharded on `axis`, map blocks sharded on
    `axis`; result sharded like the queries.

    engine: a `corr.engine` value, resolved by em_icp.resolve_engine.
    `gate` bounds the sparse engine's AABB prune — use the EM
    correspondence gate.
    """
    spec_q = P(None, axis)      # (3, Q) split along points
    spec_b = P(None, axis)      # (3, N) split into blocks
    spec_l = P(axis)
    fn = jax.shard_map(
        functools.partial(ring_class_nn_local, num_classes=num_classes,
                          axis=axis, engine=resolve_engine(engine),
                          gate=gate),
        mesh=mesh,
        in_specs=(spec_q, spec_b, spec_l, spec_l, spec_b),
        out_specs=(P(None, axis), P(None, None, axis)),
        check_vma=False,
    )
    return jax.jit(fn)
