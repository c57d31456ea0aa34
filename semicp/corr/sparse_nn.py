"""Block-sparse per-class nearest neighbour over class-major Morton tiles.

The data-layout replacement for the reference's per-class kd-trees
(SURVEY.md §2.1 row "Per-class kd-tree NN search"). The target is put in
canonical class-major Morton order once per cloud (corr/layout.py), so
every fixed-size tile covers a compact region of one or two classes.
Per EM iteration:

  1. query tiles get AABBs; `tile_candidates` lists, per query tile, the
     target tiles whose AABB lies within the correspondence gate (the
     box distance lower-bounds every point pair, so no correspondence
     inside the gate is lost);
  2. each query tile walks only its candidates, folding the classes in
     each candidate's [cmin, cmax] into running per-class (min, argmin);
  3. the winners' attribute rows are gathered once, at the end.

Contract (shared with the brute-force `class_nn_attrs_xla`): for every
(class, query) whose true per-class NN lies within the gate, d2 is that
NN's squared distance and attrs holds its (x, y, z, cov6, 1) row; beyond
the gate an entry is either INF or a real, never closer, target point.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

INF = 3.0e37
NATTR = 16    # x, y, z, cov6, found(1.0), |x|^2, label, 4 spare
ROW_T2 = 10   # |x|^2 and the label (as float, exact for class ids) ride in
ROW_LAB = 11  # the packed slab; the attrs contract zeroes rows >= 10

# Tiles and launch shape, chosen by a sweep of full aligns on an H100 at
# the bench shape (PERF.md): query tile qb (power of two), target tile
# tb (power of two, also the AABB pruning granularity), Triton warps and
# pipeline stages.
QB = 16
TB = 128
NUM_WARPS = 2
NUM_STAGES = 2


def pack_sparse(xyz, label, valid, cov6, num_classes: int, tb: int = TB) -> dict:
    """Packed target slab + per-tile metadata of a cm-sorted cloud.

    Returns attrs16 (16, N) with rows x, y, z | cov6 | ones | |x|^2 |
    label (invalid = num_classes), and the tile_meta fields lo/hi
    (n_t, 3) and cmin/cmax (n_t,)."""
    from semicp.corr.layout import tile_meta

    n = xyz.shape[1]
    tb = min(tb, n)
    if n % tb:
        raise ValueError(
            f"sparse NN: N={n} must be a multiple of the target tile "
            f"tb={tb} (pad the cloud to a power of two >= {tb})")
    label_s = jnp.where(valid, jnp.maximum(label, 0), num_classes)
    attrs16 = jnp.concatenate(
        [xyz, cov6, jnp.ones((1, n), jnp.float32),
         jnp.sum(xyz * xyz, axis=0, keepdims=True),
         label_s[None].astype(jnp.float32),
         jnp.zeros((NATTR - 12, n), jnp.float32)], axis=0)
    return {"attrs16": attrs16,
            **tile_meta(xyz, label, valid, num_classes, tb)}


def prepare_sparse(cloud, num_classes: int, cell: float, tb: int = TB) -> dict:
    """Loop-invariant prep of a target cloud for `class_nn_attrs_sparse`.

    The cloud should already be in canonical class-major Morton layout
    (corr.layout.sort_cloud_cm, applied once at preprocess time); a raw
    cloud is sorted here."""
    from semicp.corr.layout import LAYOUT_CM, sort_cloud_cm

    if cloud.layout != LAYOUT_CM:
        cloud = sort_cloud_cm(cloud, num_classes, cell)
    return pack_sparse(cloud.xyz, cloud.label, cloud.valid, cloud.cov6,
                       num_classes, tb)


def _dist2(qx, qy, qz, q2, tx, ty, tz, t2):
    """Expanded squared distance in f32 FMAs on the CUDA cores (no TF32:
    a 3-deep product gains nothing from tensor cores). Its cancellation
    error is the brute force's: ~|x|^2 * 2^-23 (corr/bruteforce.py)."""
    return q2 + t2 - 2.0 * (qx * tx + qy * ty + qz * tz)


def _nn_kernel(cand_ref, count_ref, cmin_ref, cmax_ref, qx_ref, qy_ref,
               qz_ref, attrs_ref, d2_ref, idx_ref, *, tb, n_tt):
    """One program per query tile: walk its candidate target tiles,
    keeping the per-class running (min, argmin) in registers."""
    i = pl.program_id(0)
    kp, qb = d2_ref.shape
    qx, qy, qz = qx_ref[...], qy_ref[...], qz_ref[...]
    q2 = qx * qx + qy * qy + qz * qz
    rows = jax.lax.broadcasted_iota(jnp.int32, (kp, qb), 0)

    def cand_body(c, carry):
        tid = cand_ref[i * n_tt + c]
        ts = pl.ds(tid * tb, tb)
        tx = plgpu.load(attrs_ref.at[0, ts])
        ty = plgpu.load(attrs_ref.at[1, ts])
        tz = plgpu.load(attrs_ref.at[2, ts])
        t2 = plgpu.load(attrs_ref.at[ROW_T2, ts])
        lab = plgpu.load(attrs_ref.at[ROW_LAB, ts])
        d2 = _dist2(qx[:, None], qy[:, None], qz[:, None], q2[:, None],
                    tx[None, :], ty[None, :], tz[None, :], t2[None, :])

        def class_body(k, carry):
            bd, bi = carry
            dk = jnp.where(lab[None, :] == k.astype(jnp.float32), d2, INF)
            m = jnp.min(dk, axis=1)
            a = jnp.argmin(dk, axis=1).astype(jnp.int32) + tid * tb
            upd = (rows == k) & (m[None, :] < bd)
            return (jnp.where(upd, m[None, :], bd),
                    jnp.where(upd, a[None, :], bi))

        # class-major tiles hold the contiguous class range [cmin, cmax],
        # usually one class: fold only those
        return jax.lax.fori_loop(cmin_ref[tid], cmax_ref[tid] + 1,
                                 class_body, carry)

    init = (jnp.full((kp, qb), INF, jnp.float32),
            jnp.zeros((kp, qb), jnp.int32))
    bd, bi = jax.lax.fori_loop(0, count_ref[i], cand_body, init)
    d2_ref[...] = bd
    idx_ref[...] = bi


def _walk(attrs16, cmin, cmax, q_xyz, cand, count, num_classes: int,
          qb: int, tb: int):
    """The kernel over all query tiles: (d2 (K, Q), target index (K, Q))
    of each class's nearest candidate; compiled through Triton on a GPU,
    interpreted on the CPU backend (tests)."""
    n = attrs16.shape[1]
    q = q_xyz.shape[1]
    n_tt = n // tb
    kp = pl.next_power_of_2(num_classes)
    qspec = pl.BlockSpec((qb,), lambda i: (i,))
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    ospec = pl.BlockSpec((kp, qb), lambda i: (0, i))
    d2, idx = pl.pallas_call(
        functools.partial(_nn_kernel, tb=tb, n_tt=n_tt),
        grid=(q // qb,),
        in_specs=[anyspec] * 4 + [qspec] * 3 + [anyspec],
        out_specs=(ospec, ospec),
        out_shape=(jax.ShapeDtypeStruct((kp, q), jnp.float32),
                   jax.ShapeDtypeStruct((kp, q), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=jax.default_backend() == "cpu",
        name="semicp_sparse_nn",
    )(cand.reshape(-1), count, cmin, cmax, q_xyz[0], q_xyz[1], q_xyz[2],
      attrs16)
    return d2[:num_classes], idx[:num_classes]


def gather_attrs(attrs16, d2, idx):
    """(K, 16, Q) attribute rows of the winners idx (K, Q); zero where
    d2 is INF (no target of that class within reach)."""
    rows = jnp.take(attrs16[:10], idx, axis=1)             # (10, K, Q)
    rows = jnp.where((d2 < INF)[None], rows, 0.0)
    k, q = d2.shape
    return jnp.concatenate(
        [jnp.moveaxis(rows, 0, 1), jnp.zeros((k, NATTR - 10, q), jnp.float32)],
        axis=1)


@functools.partial(jax.jit, static_argnames=("num_classes", "qb"))
def class_nn_attrs_sparse(prep: dict, q_xyz, q_valid, num_classes: int,
                          gate, qb: int = QB):
    """Block-sparse per-class NN: class-major Morton tiles + AABB pruning.

    prep comes from `prepare_sparse` / `pack_sparse`; q_xyz (3, Q) are
    the query planes (Q a multiple of qb), q_valid (Q,) their mask. Queries
    should be cm/Morton-sorted so query tiles cover compact regions (what
    makes pruning bite); exactness does not depend on it. `gate` may be
    traced. Returns (d2 (K, Q), attrs (K, 16, Q)); see the module
    docstring for the contract.
    """
    from semicp.corr.layout import tile_candidates
    from semicp.corr.morton import tile_aabbs

    attrs16 = prep["attrs16"]
    n = attrs16.shape[1]
    q = q_xyz.shape[1]
    qb = min(qb, q)
    if q % qb:
        raise ValueError(
            f"sparse NN: Q={q} must be a multiple of the query tile qb={qb} "
            f"(pad queries to a power of two >= {qb})")
    tb = n // prep["lo"].shape[0]
    qlo, qhi = tile_aabbs(q_xyz, q_valid, qb)
    cand, count = tile_candidates(qlo, qhi, prep["lo"], prep["hi"], gate)
    d2, idx = _walk(attrs16, prep["cmin"], prep["cmax"], q_xyz, cand, count,
                    num_classes, qb, tb)
    return d2, gather_attrs(attrs16, d2, idx)


def class_nn_attrs_xla(tgt_xyz, tgt_label, tgt_valid, tgt_cov6, q_xyz,
                       num_classes: int):
    """Brute-force reference with the same contract (exact everywhere):
    every query against every target tile (corr/bruteforce.py)."""
    from semicp.corr.bruteforce import class_nn

    idx, d2 = class_nn(tgt_xyz, jnp.maximum(tgt_label, 0),
                       tgt_valid, q_xyz, num_classes)
    n = tgt_xyz.shape[1]
    attrs16 = jnp.concatenate(
        [tgt_xyz, tgt_cov6, jnp.ones((1, n), jnp.float32)], axis=0)
    return d2, gather_attrs(attrs16, d2, idx)
