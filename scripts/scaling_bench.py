"""Scaling-efficiency harness: batched alignment throughput vs device count.

Weak scaling — the batch grows with the mesh so each device always
aligns `pairs_per_dev` pairs, over 1, 2, 4, ... of the host's cards.
Needs a GPU: it prints the card and refuses to report from the CPU.
Multi-host: launch one process per host; semicp.dist.mesh.
init_distributed runs first.

Usage: python scripts/scaling_bench.py [pairs_per_dev] [n_points]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from semicp.cli.common import setup_jax
    from semicp.utils.device import card_info, require_gpu

    setup_jax()
    device = require_gpu()
    print(f"card: {card_info()}; device: {device}")
    pairs_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    n_points = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    from semicp.cloud import make_cloud, preprocess_cloud
    from semicp.config import Config
    from semicp.data import make_pair, make_scene
    from semicp.dist import batched_align, make_mesh
    from semicp.dist.batch import shard_batch

    n_pad = 1 << int(np.ceil(np.log2(n_points * 2)))
    cfg = Config().override({
        "cloud.n_pad": n_pad, "cloud.num_classes": 8, "em.max_iters": 12,
    })
    rng = np.random.default_rng(0)
    xyz, lab = make_scene(rng, n_points=n_points, extent=15.0)
    lab = lab - 1
    delta = np.array([0.3, -0.1, 0.05, 0.01, -0.01, 0.03])
    src, slab, _ = make_pair(rng, xyz, lab, delta, n_classes=8)
    src_c = preprocess_cloud(make_cloud(src, slab, n_pad=n_pad), cfg)
    tgt_c = preprocess_cloud(make_cloud(xyz, lab, n_pad=n_pad), cfg)

    devices = jax.devices()
    results = {}
    rows = []
    n_list = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    for nd in n_list:
        mesh = make_mesh({"pairs": nd}, devices=devices[:nd])
        b = nd * pairs_per_dev
        src_b = jax.tree.map(lambda x: jnp.stack([x] * b), src_c)
        tgt_b = jax.tree.map(lambda x: jnp.stack([x] * b), tgt_c)
        T0_b = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (b, 4, 4))
        src_b, tgt_b, T0_b = (shard_batch(mesh, x) for x in (src_b, tgt_b, T0_b))
        fn = batched_align(mesh, cfg)
        res = fn(src_b, tgt_b, T0_b)
        jax.block_until_ready(res)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            res = fn(src_b, tgt_b, T0_b)
        jax.block_until_ready(res)
        dt = (time.perf_counter() - t0) / reps
        fps = b / dt
        results[nd] = fps
        eff = fps / (results[1] * nd) if 1 in results and nd > 1 else 1.0
        rows.append({"devices": nd, "batch": b,
                     "aligns_per_s": round(fps, 3),
                     "efficiency": round(eff, 4)})
        print(f"devices={nd:3d}  batch={b:3d}  {fps:8.2f} aligns/s  "
              f"efficiency={eff*100:5.1f}%")

    out = os.environ.get("SCALING_OUT")
    if out:
        import json

        json.dump({"device": device, "card": card_info(),
                   "pairs_per_dev": pairs_per_dev, "n_points": n_points,
                   "rows": rows}, open(out, "w"), indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
