"""Runtime plumbing: engine choice, compile cache, the refusal to run
without a GPU, checkpoints, and the Cloud pytree."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semicp.cloud.cloud import Cloud, make_cloud
from semicp.register import em_icp

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("engine,backend,want", [
    ("auto", "cpu", "xla"),
    ("auto", "gpu", "sparse"),
    ("sparse", "cpu", "sparse"),
    ("sparse", "gpu", "sparse"),
    ("xla", "gpu", "xla"),
])
def test_resolve_engine(monkeypatch, engine, backend, want):
    monkeypatch.setattr(em_icp.jax, "default_backend", lambda: backend)
    assert em_icp.resolve_engine(engine) == want


@pytest.mark.parametrize("engine", ["dense", "pallas", ""])
def test_resolve_engine_rejects_unknown(engine):
    with pytest.raises(ValueError, match="corr.engine"):
        em_icp.resolve_engine(engine)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from semicp.cli.common import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from semicp.cli.common import CACHE_DIR, compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == str(CACHE_DIR) == str(REPO / ".jax_cache")
    assert compile_cache_dir() == compile_cache_dir()
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split("\n")


def test_require_gpu_refuses_cpu(monkeypatch):
    from semicp.utils.device import require_gpu

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu(allow_cpu=True)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()                      # benchmarks never accept the CPU


def test_require_gpu_allows_explicit_cpu(monkeypatch):
    from semicp.utils.device import require_gpu

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    dev = require_gpu(allow_cpu=True)
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_driver_refuses_without_gpu(monkeypatch):
    from semicp.cli import run_pair

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="no GPU"):
        run_pair.main(["--synthetic", "500", "--cloud.n_pad=512"])


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Run from the checkout on the CPU, and alone in a directory, the
    smoke test exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_checkpoint_round_trip(tmp_path):
    from semicp.utils.checkpoint import latest_checkpoint, save_checkpoint

    assert latest_checkpoint(tmp_path / "none") == (None, None)
    state = {"graph": {"poses": np.arange(32, dtype=np.float32).reshape(2, 4, 4),
                       "n_poses": np.asarray(2, np.int32)},
             "frame": np.asarray(7, np.int32),
             "kf_clouds": {"valid": np.array([True, False])}}
    save_checkpoint(tmp_path, state, step=2)
    state2 = {**state, "frame": np.asarray(9, np.int32)}
    save_checkpoint(tmp_path, state2, step=10)
    # a torn write (temporary file) is never mistaken for a checkpoint
    (tmp_path / ".step_11.npz.tmp").write_bytes(b"partial")
    step, got = latest_checkpoint(tmp_path)
    assert step == 10
    assert int(got["frame"]) == 9 and int(got["graph"]["n_poses"]) == 2
    np.testing.assert_array_equal(got["graph"]["poses"], state["graph"]["poses"])
    assert got["kf_clouds"]["valid"].dtype == bool
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_10.npz", "step_2.npz"]


def test_checkpoint_rejects_ambiguous_keys(tmp_path):
    from semicp.utils.checkpoint import save_checkpoint

    with pytest.raises(ValueError, match="'/'"):
        save_checkpoint(tmp_path, {"a/b": np.zeros(1)}, step=0)


def test_cloud_pytree_static_layout():
    c = make_cloud(np.zeros((5, 3), np.float32), n_pad=8)
    leaves, tree = jax.tree.flatten(c)
    assert len(leaves) == 5                       # layout is not a leaf
    c_cm = c.replace(layout="cm")
    assert c_cm.layout == "cm" and c.layout == "raw"
    assert jax.tree.structure(c_cm) != tree       # layout keys the treedef
    traces = []

    @jax.jit
    def f(cloud):
        traces.append(cloud.layout)
        return cloud.replace(xyz=cloud.xyz + 1.0)

    out = f(c_cm)
    assert out.layout == "cm" and isinstance(out, Cloud)
    f(c_cm)
    f(c)
    assert traces == ["cm", "raw"]                # one trace per layout
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), c_cm, c_cm)
    assert batched.layout == "cm" and batched.xyz.shape == (2, 3, 8)
