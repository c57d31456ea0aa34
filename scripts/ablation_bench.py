"""Semantic-vs-uniform ablation under label corruption (SURVEY.md §4.3).

Sweeps make_pair(label_flip=...) on the corridor scene — geometry that
is translation-invariant along x, so the x offset is observable ONLY
through semantics — and records the pose error of semantic EM-ICP vs
the uniform-weight GICP ablation at each corruption level. This is the
paper's core claim as a measured curve (VERDICT r4 missing #3): the
confusion-matrix alpha model keeps semantic EM useful well past 40%%
corrupted labels, degrading toward (never below-by-much) uniform GICP.

    python scripts/ablation_bench.py [out.json]   # default ABLATION_r05.json

Runs on CPU by design (deterministic, chip-free): the curve is
algorithmic, not a perf number.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from semicp.cli.common import setup_jax

    setup_jax()

    from semicp import Config
    from semicp.cloud import make_cloud, preprocess_cloud
    from semicp.data import make_pair
    from semicp.register import align, align_gicp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    from test_register import corridor_scene, pose_errors

    out_path = sys.argv[1] if len(sys.argv) > 1 else "ABLATION_r05.json"
    cfg = Config().override({
        "cloud.n_pad": 4096, "cloud.num_classes": 6,
        "em.alpha": 0.9, "em.max_iters": 50,
    })
    delta = np.array([0.6, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)

    def prep(xyz, lab):
        return preprocess_cloud(make_cloud(xyz, lab, n_pad=4096), cfg.cov)

    rows = []
    for flip in (0.0, 0.2, 0.4, 0.6):
        errs_s, errs_u = [], []
        for seed in range(3):
            rng = np.random.default_rng(seed)
            tgt, tlab = corridor_scene(rng, 1200)
            src, slab, T_gt = make_pair(rng, tgt, tlab, delta, noise=0.01,
                                        dropout=0.2, n_classes=6,
                                        label_flip=flip)
            sc, tc = prep(src, slab), prep(tgt, tlab)
            errs_s.append(pose_errors(align(sc, tc, cfg).T, T_gt)[0])
            errs_u.append(pose_errors(align_gicp(sc, tc, cfg).T, T_gt)[0])
        row = {"label_flip": flip,
               "trans_err_semantic_m": float(np.mean(errs_s)),
               "trans_err_uniform_m": float(np.mean(errs_u)),
               "seeds": len(errs_s)}
        rows.append(row)
        print(f"flip={flip:.1f}: semantic {row['trans_err_semantic_m']:.3f} m"
              f"  uniform {row['trans_err_uniform_m']:.3f} m", file=sys.stderr)

    result = {
        "scene": "corridor (x-translation observable only via semantics)",
        "offset_m": 0.6, "alpha": 0.9, "rows": rows,
    }
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
