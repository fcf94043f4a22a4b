"""Checkpoints of a whole converter in a torch-native format, in place of the
JAX package's Orbax checkpoints (runtime/checkpoints.py there).

Layout: one directory, one file per part (`tokenizer.pt`, `vocoder.pt`,
`arvc.pt`, `campplus.pt`, `speaker.pt`), each `torch.save` of that part's
parameter tree in the port's layouts, on the CPU.  A part the converter
lacks has no file.  The fused kernels' packed weights are not saved: a
loaded `Converter` packs them again for its program set.  Loading reads
with `weights_only=True` (tensors, dicts and lists only) onto the card
unless `device="cpu"` is given.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.config import PipelineConfig
from streamvoiceanon_tpu_torch.params import Converter
from streamvoiceanon_tpu_torch.utils.tree import tree_map

PARTS = ("tokenizer", "vocoder", "arvc", "campplus", "speaker")
PACKED = ("enc_packed", "enc_units", "head_packed")


def save_tree(tree: Dict, path: str) -> None:
    """`torch.save` of a parameter tree's tensors, detached and on the CPU."""
    torch.save(tree_map(lambda t: t.detach().cpu(), tree), path)


def load_tree(path: str, device: torch.device) -> Dict:
    return torch.load(path, map_location=device, weights_only=True)


def save(cv, path: str) -> str:
    """Write `cv` (a `Converter`, or a `VoiceConverter` holding one) under
    `path`.  Returns the absolute path."""
    cv = getattr(cv, "converter", cv)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for name in PARTS:
        tree = getattr(cv, f"{name}_params")
        if tree is not None:
            save_tree({k: v for k, v in tree.items() if k not in PACKED},
                      os.path.join(path, f"{name}.pt"))
    return path


def load(path: str, cfg: Optional[PipelineConfig] = None,
         device: Optional[str] = None) -> Converter:
    """The converter saved under `path`, on `device` (the card unless
    given), under `cfg` (`PipelineConfig()` unless given)."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    trees = {}
    for name in PARTS:
        f = os.path.join(path, f"{name}.pt")
        trees[f"{name}_params"] = load_tree(f, dev) if os.path.isfile(f) else None
    return Converter(cfg=cfg or PipelineConfig(), device=dev, **trees)
