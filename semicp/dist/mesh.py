"""Device mesh + process bootstrap — the communication backend.

Reference counterpart: none — the reference is a single-process CPU
program with no MPI/NCCL/Gloo (SURVEY.md §2.3, §5 "Distributed
communication backend"). All distribution here is new capability: a
named `jax.sharding.Mesh` over which shard_map programs run XLA
collectives (psum / all_gather / ppermute), which XLA hands to NCCL on
GPUs. Every card of a host reaches every other at the same rate, so a
mesh follows the algorithm's axes, not a physical topology. XLA owns
the wire; there is no custom transport.

Multi-host: call `init_distributed()` once per process before any mesh
construction (jax.distributed.initialize discovers peers via the
standard coordinator env vars). In this sandbox multi-chip paths are
exercised on a virtual CPU mesh (tests/conftest.py) and via
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bootstrap multi-host JAX. Safe to skip single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a named mesh. axes maps axis name -> size; total must equal
    the device count (a trailing axis of -1 absorbs the remainder)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if not axes:
        return Mesh(np.asarray(devices), ("pairs",))
    names, sizes = zip(*axes.items())
    sizes = list(sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return Mesh(np.asarray(devices).reshape(sizes), names)


def default_mesh() -> Mesh:
    return make_mesh()
