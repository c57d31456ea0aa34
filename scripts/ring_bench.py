"""Ring-step microbench at map-block scale.

Times one full ring sweep (mesh {"blocks": n_dev}) of the block-sparse
NN walk over a large map, and checks it against the brute-force engine
on a query slice. On one card the ring degenerates to one step, which
is exactly the per-step cost that rotates across cards. Needs a GPU.

    python scripts/ring_bench.py [map_points] [query_points] [classes]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def steady(fn, reps=5):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    n_map = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 19   # 524288
    n_q = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 17     # 131072
    K = int(sys.argv[3]) if len(sys.argv) > 3 else 20

    from semicp.cli.common import setup_jax
    from semicp.utils.device import card_info, require_gpu

    setup_jax()
    device = require_gpu()
    print(f"card: {card_info()}; device: {device}")

    from semicp.cloud import make_cloud
    from semicp.config import Config
    from semicp.data import make_scene
    from semicp.dist import make_mesh
    from semicp.dist.ring_corr import make_ring_nn

    n_dev = len(jax.devices())
    cfg = Config().override({"cloud.n_pad": n_map, "cloud.num_classes": K})
    rng = np.random.default_rng(0)
    # a map-sized scene: several scans' worth of structured points. A
    # product map is fused from per-scan PREPROCESSED keyframe clouds
    # (slam/submap.py), so covariances arrive precomputed; their values
    # do not affect NN timing — synthesize them here
    pts, lab = make_scene(rng, n_points=int(n_map * 0.9), extent=120.0,
                          n_classes=K)
    lab = lab - 1
    cloud = make_cloud(pts, lab, n_pad=n_map)
    cloud = cloud.replace(cov6=jnp.asarray(
        rng.normal(size=(6, n_map)).astype(np.float32) * 0.01))
    qsel = rng.choice(int(n_map * 0.9), size=n_q, replace=False)
    q = jnp.asarray(pts[qsel].T.astype(np.float32))
    # product query clouds arrive class-major-Morton sorted; without a
    # spatial sort, query-tile AABBs span the whole map and the sparse
    # engine's pruning is inert
    from semicp.corr.morton import morton_order

    q = jnp.take(q, morton_order(q, jnp.ones(n_q, bool), cfg.corr.cell),
                 axis=1)
    cloud = jax.block_until_ready(cloud)

    mesh = make_mesh({"blocks": n_dev})
    print(f"map={n_map} queries={n_q} K={K} devices={n_dev} "
          f"gate={cfg.corr.max_dist}")
    results = {}
    for engine in ("sparse", "xla"):
        ring = make_ring_nn(mesh, num_classes=K, engine=engine,
                            gate=cfg.corr.max_dist)
        qs = q if engine == "sparse" else q[:, :8192]
        fn = lambda: ring(qs, cloud.xyz, cloud.label,  # noqa: E731
                          cloud.valid, cloud.cov6)
        ms = steady(fn, reps=5 if engine == "sparse" else 1)
        results[engine] = fn()
        print(f"  ring step [{engine:6s}] {qs.shape[1]} queries: {ms:9.2f} ms")

    # agreement with the brute force on the first 8192 queries
    d2_x = np.asarray(results["xla"][0])
    d2_s = np.asarray(results["sparse"][0][:, :8192])
    g2 = cfg.corr.max_dist ** 2 * (1 - 1e-5)
    inside = d2_x <= g2
    err = np.abs(d2_s[inside] - d2_x[inside]).max() if inside.any() else 0.0
    print(f"  within-gate agreement: max |d2 diff| = {err:.2e} "
          f"({inside.mean()*100:.1f}% of (K,Q) within gate)")


if __name__ == "__main__":
    main()
