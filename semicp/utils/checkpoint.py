"""Checkpoint / resume for SLAM state as numpy archives (SURVEY.md §5).

Reference counterpart: none — the reference's only resume point is its
append-only poses file. Here the full SLAM state {pose graph, keyframe
payloads, frame anchors} is checkpointed every cfg.slam.checkpoint_every
keyframes and `--resume` re-enters at the last checkpoint.

Format: one `step_<step>.npz` per checkpoint, holding the state's
leaves under their '/'-joined dict paths. Each file is written to a
temporary name and renamed into place, so a crash mid-save leaves the
previous checkpoint as the latest complete one.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key, val in tree.items():
        if "/" in key:
            raise ValueError(f"checkpoint keys must not contain '/': {key!r}")
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def _unflatten(flat) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def save_checkpoint(path: str | Path, state: dict, step: int) -> None:
    """Write `state` (nested dicts of arrays) as checkpoint `step`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    final = path / f"step_{int(step)}.npz"
    tmp = path / f".step_{int(step)}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **_flatten(state))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)


def latest_checkpoint(path: str | Path):
    """Return (step, state) of the newest checkpoint, or (None, None)."""
    path = Path(path)
    if not path.is_dir():
        return None, None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := _NAME.match(f))]
    if not steps:
        return None, None
    step = max(steps)
    with np.load(path / f"step_{step}.npz") as data:
        return step, _unflatten({k: data[k] for k in data.files})
