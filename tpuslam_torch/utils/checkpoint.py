"""Checkpoint / resume: named trees of tensors in one ``.npz``.

Port of ``tpuslam/utils/checkpoint.py`` with the same file layout, so a
checkpoint written by either package loads in the other: each named tree
is flattened to ``"{name}.leaf_{i}"`` arrays, and ``__manifest__`` holds
JSON bytes with each name's ``n_leaves`` and ``type``.

The leaf order is JAX's pytree order: a dict's keys sorted, a tuple, list
or NamedTuple in field order, ``None`` an empty subtree (no leaf), and
anything else (a tensor, a numpy array, a Python scalar) one leaf.  A
Python ``int``, ``float`` or ``bool`` is written as a 0-d int32, float32
or bool array (what ``jnp.asarray`` makes of it) and read back as a Python
scalar of its template's type, so a host counter such as
``VoState.frame_idx`` stays an ``int``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

_SCALARS = {bool: np.bool_, int: np.int32, float: np.float32}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in flatten(x)]
    return [tree]


def _unflatten(template: Any, leaves: list, device: torch.device) -> Any:
    """``template``'s structure with its leaves taken in order from ``leaves`` (consumed)."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves, device) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(x, leaves, device) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves, device) for x in template)
    arr = leaves.pop(0)
    if type(template) in _SCALARS:
        return type(template)(arr.item())
    return torch.from_numpy(np.array(arr)).to(device)


def _to_numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if type(leaf) in _SCALARS:
        return np.asarray(leaf, _SCALARS[type(leaf)])
    return np.asarray(leaf)


def save_state(path: str | Path, **trees: Any) -> None:
    """Save named trees (e.g. ``state=carry, trajectory=poses``) to one ``.npz``."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, Any] = {}
    for name, tree in trees.items():
        leaves = flatten(tree)
        manifest[name] = {"n_leaves": len(leaves), "type": type(tree).__name__}
        for i, leaf in enumerate(leaves):
            arrays[f"{name}.leaf_{i}"] = _to_numpy(leaf)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_state(path: str | Path, device: torch.device | str = "cuda", **templates: Any) -> dict[str, Any]:
    """Load trees saved by :func:`save_state` (by either package) onto ``device``.

    ``templates`` gives an example tree for each name, for its structure
    (shapes and dtypes come from the file); every array leaf comes back as
    a tensor on ``device``, every scalar leaf as its template's Python type.
    """
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Checkpoint not found: {path}")
    device = torch.device(device)
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        out: dict[str, Any] = {}
        for name, template in templates.items():
            if name not in manifest:
                raise KeyError(f"Checkpoint has no state named '{name}'")
            n = manifest[name]["n_leaves"]
            n_template = len(flatten(template))
            if n_template != n:
                raise ValueError(f"Template for '{name}' has {n_template} leaves, checkpoint has {n}")
            out[name] = _unflatten(template, [data[f"{name}.leaf_{i}"] for i in range(n)], device)
    return out
