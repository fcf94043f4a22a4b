"""Named presets and the persisted in-use configuration, as the JAX
package's runtime/presets.py (the reference GUI's configs/presets.json
and configs/inuse/config.json)."""

from __future__ import annotations

import dataclasses
import json
import os

from streamvoiceanon_tpu_torch.config import PRESETS, StreamConfig


def save_inuse(scfg: StreamConfig, path: str = "configs/inuse/config.json") -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(scfg), f, indent=2)
    return path


def load_inuse(path: str = "configs/inuse/config.json") -> StreamConfig:
    with open(path) as f:
        data = json.load(f)
    return StreamConfig(**data)


def list_presets() -> dict:
    return {name: dataclasses.asdict(cfg) for name, cfg in PRESETS.items()}
