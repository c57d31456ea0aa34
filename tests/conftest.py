"""Test harness config: an 8-device CPU mesh by default (SURVEY.md §4.6).

Tests run on a virtual 8-device CPU backend so distributed code paths
(shard_map, psum, ppermute) execute in one process, and Pallas kernels
run in interpret mode. Must run before jax initializes its backends,
hence module level here.

The GPU lane (`SEMICP_GPU_TESTS=1 pytest -m gpu`, one process, no -n)
keeps the real card: tests marked `gpu` compile their kernels for it and
compare them with the plain references. Without a card they skip, and
they decide that inside the `gpu` fixture, never at import.
"""

import os

GPU_LANE = os.environ.get("SEMICP_GPU_TESTS") == "1"

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from semicp.cli.common import setup_jax  # noqa: E402

# Persistent XLA compile cache for the suite: entries are keyed by HLO
# content hash, so stale entries cannot be wrong-by-content — they just
# stop hitting when code changes.
setup_jax()

if os.environ.get("SEMICP_DEBUG_NANS") == "1":
    # Numeric-sanitization lane (SURVEY.md §5 "race detection /
    # sanitizers"): every jitted program traps on the first NaN it
    # produces instead of propagating it into a silently-degraded pose.
    # Run once per round: SEMICP_DEBUG_NANS=1 pytest -q. The eig3
    # zero-matrix NaN (commit 752b253) is this lane's target bug class.
    jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU: run with SEMICP_GPU_TESTS=1 pytest -m gpu on a card")
    return devs[0]
