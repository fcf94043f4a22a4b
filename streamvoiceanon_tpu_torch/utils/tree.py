"""Parameter trees as flat dicts: nested dicts of tensors keyed by their
path of dict keys, in sorted key order (the JAX package's leaf order)."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Path = Tuple[str, ...]


def flatten(tree: Dict, prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    """{path: leaf} of a nested dict, keys sorted at every level."""
    out: Dict[Path, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def tree_map(fn: Callable, tree):
    """fn over every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
