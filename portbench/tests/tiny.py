"""A tiny copy of the benchmark for CPU tests: `portbench/` copied into a
temporary root, its configuration cut to a few channels and layers, its
traffic to a few seconds, and cells resolved from a BENCHMARK object."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_pipeline(p: dict) -> dict:
    p = copy.deepcopy(p)
    bb = {"input_channels": 160, "depths": [1, 1, 1, 1], "dims": [16, 16, 16, 32],
          "kernel_size": 7, "mlp_ratio": 4.0, "layer_scale_init_value": 1e-6,
          "gin_channels": 0, "drop_path_rate": 0.0}
    t = p["tokenizer"]
    t["backbone"] = dict(bb)
    t["quantizer"]["input_dim"] = 32
    t["transformer"].update(n_layer=2, n_head=2, dim=32, intermediate_size=64, head_dim=16,
                            window_size=16)
    t["head"].update(input_channels=32)
    v = p["vocoder"]
    v["backbone"] = dict(bb)
    v["quantizer"]["input_dim"] = 32
    v["head"].update(num_mels=32, upsample_initial_channel=32)
    p["arvc"]["decoder"].update(
        n_layer=2, n_head=2, n_local_heads=2, dim=32, intermediate_size=64, head_dim=16,
        max_seq_len=512, n_fast_layer=1, fast_dim=32, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=16, fast_intermediate_size=64, cond_input_dim=32)
    p["arvc"]["model_dim"] = 32
    p["campplus"].update(block_layers=[1, 1, 1], init_channels=32)
    p["speaker"].update(ecapa_channels=64)
    p["stream"].update(max_prompt_frames=32, max_seq_frames=64, buffer_frames=8)
    return p


def make_root(tmp: Path) -> Path:
    """A tiny benchmark root under tmp; returns its `portbench` directory."""
    root = tmp / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    for f in (root / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["pipeline"] = tiny_pipeline(cfg["pipeline"])
        f.write_text(json.dumps(cfg))
    edits = {"vpc-testclean": dict(ref_seconds=2.0, warmup_seconds=[0.5], profile_s=0.3,
                                   check_utts=3, lengths={"count": 4, "mean_s": 1.5,
                                                          "sigma": 0.3, "min_s": 0.6,
                                                          "max_s": 2.5}),
             "train-emilia": dict(batch_size=2, profile_s=0.3,
                                  lengths={"count": 10, "mean_s": 1.0, "sigma": 0.3,
                                           "min_s": 0.5, "max_s": 1.5})}
    for name, ed in edits.items():
        f = root / "traffic" / f"{name}.json"
        tr = json.loads(f.read_text())
        tr.update(ed)
        f.write_text(json.dumps(tr))
    return root


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())
