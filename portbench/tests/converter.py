"""What the kinds that run the converter's `PipelineConfig` share (the
`anonymize` and `train` kinds, `tests/kinds/`): the configuration's tiny
cut, its field-for-field check against the port's config, and the fault
of a content token altered where the tokenizer produces it."""

from __future__ import annotations

import copy
import dataclasses
import json

from portbench import core


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


def tiny_config(cfg: dict) -> dict:
    return dict(cfg, pipeline=tiny_pipeline(cfg["pipeline"]))


def check_config(cfg: dict, root) -> None:
    """The configuration file's `pipeline` builds the port's PipelineConfig field for field."""
    built = core.port_config(cfg["pipeline"])
    assert json.loads(json.dumps(dataclasses.asdict(built))) == cfg["pipeline"]


def content(mp, root):
    from streamvoiceanon_tpu_torch.models import tokenizer

    orig = tokenizer.encode
    mp.setattr(tokenizer, "encode", lambda *a, **k: orig(*a, **k) ^ 1)
