"""Parameter trees as flat dicts: nested dicts (and lists) of tensors keyed
by their path of dict keys and list indices, dict keys in sorted order (the
JAX package's leaf order)."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

Path = Tuple[Union[str, int], ...]


def flatten(tree, prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    """{path: leaf} of a nested dict, keys sorted at every level; a list's
    items follow in order under their indices."""
    out: Dict[Path, torch.Tensor] = {}
    items = (sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
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
