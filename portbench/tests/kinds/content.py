"""The `content` kind (`drivers/content.py`) as the harness's CPU tests know
it: its tiny cut (a 9-layer conformer of 512 wide in 8 heads of 64, the
published clamp ranges and kernel, run to layer 8: deep and wide enough
that float16's error stays well below the limits while bfloat16's and a
missing relative-position bias exceed them, as at the published size),
its configuration check against the port's `PipelineConfig()` tokenizer
and CAM++, `ASRDecoderConfig()` and `W2VBertConfig()`, and its faults: the teacher stopped one layer early,
its relative-position bias left out, the teacher run in bfloat16, half of
the batch left out of the loss, and the updates skipped after set-up."""

import copy
import dataclasses
import json

from portbench import core

TINY = {"batch_size": 2, "profile_s": 0.3,
        "lengths": {"count": 8, "mean_s": 1.0, "sigma": 0.3, "min_s": 0.6, "max_s": 1.5}}


def tiny_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    t = cfg["tokenizer"]
    t["backbone"].update(depths=[1, 1, 1, 1], dims=[16, 16, 16, 32])
    t["quantizer"]["input_dim"] = 32
    t["transformer"].update(n_layer=2, n_head=2, dim=32, intermediate_size=64, head_dim=16,
                            window_size=16)
    t["head"].update(input_channels=32, depths=[1, 1], dims=[16, 512])
    cfg["campplus"].update(block_layers=[1, 1, 1], init_channels=32)
    cfg["teacher"].update(hidden=512, n_layers=9, n_heads=8, intermediate=1024)
    cfg["teacher_layers"] = 8
    cfg["asr_decoder"].update(hidden_dim=32, num_heads=2, depth=1, in_channels=32)
    return cfg


def tiny_traffic(tr: dict) -> dict:
    return dict(tr, **TINY)


def check_config(cfg: dict, root) -> None:
    """The file's groups are the port's configurations field for field; the
    teacher runs within the published depth."""
    from streamvoiceanon_tpu_torch.models.asr_decoder import ASRDecoderConfig
    from streamvoiceanon_tpu_torch.models.w2v_bert_native import W2VBertConfig

    as_json = lambda x: json.loads(json.dumps(dataclasses.asdict(x)))  # noqa: E731
    built = core.port_config({k: cfg[k] for k in ("sample_rate", "resample_rate", "tokenizer",
                                                  "campplus")})
    assert as_json(built.tokenizer) == cfg["tokenizer"]
    assert as_json(built.campplus) == cfg["campplus"]
    assert as_json(ASRDecoderConfig(**cfg["asr_decoder"])) == cfg["asr_decoder"]
    assert as_json(W2VBertConfig(**cfg["teacher"])) == cfg["teacher"]
    assert 0 < cfg["teacher_layers"] <= cfg["teacher"]["n_layers"]
    assert cfg["tokenizer"]["head"]["dims"][-1] == cfg["teacher"]["hidden"]
    assert cfg["tokenizer"]["head"]["gin_channels"] == cfg["campplus"]["embedding_size"]
    assert {core.DTYPES[v] for v in cfg["dtypes"].values()}


def teacher_one_layer_early(mp, root):
    from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

    orig = wn.apply
    mp.setattr(wn, "apply", lambda p, c, f, mask=None, num_layers=None:
               orig(p, c, f, mask=mask, num_layers=num_layers - 1))


def no_position_bias(mp, root):
    import torch

    from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

    mp.setattr(wn, "_rel_key_bias", lambda q, table, left, right: torch.zeros(
        q.shape[:3] + (q.shape[2],), dtype=q.dtype, device=q.device))


def teacher_in_bfloat16(mp, root):
    import torch

    from streamvoiceanon_tpu_torch.models.w2v_bert import W2vBertTeacher

    orig = W2vBertTeacher.__init__
    mp.setattr(W2vBertTeacher, "__init__",
               lambda self, *a, **k: orig(self, *a, **{**k, "dtype": torch.bfloat16}))


def half_batch(mp, root):
    import torch

    from streamvoiceanon_tpu_torch.train import asr_trainer

    orig = asr_trainer.loss_fn

    def half(params, cfg, acfg, tcfg, batch):
        h = max(1, batch["waves"].shape[0] // 2)
        return orig(params, cfg, acfg, tcfg, {k: v[:h] if torch.is_tensor(v) else v
                                              for k, v in batch.items()})
    mp.setattr(asr_trainer, "loss_fn", half)


def updates_skipped_after_setup(mp, root):
    """Steps past the set-up's checked ones leave the parameters as they
    are, as a fault that sets in once the program is warm would."""
    from streamvoiceanon_tpu_torch.train import muon

    orig, n = muon.apply_updates, {"calls": 0}

    def late(params, updates):
        n["calls"] += 1
        if n["calls"] <= 3:
            orig(params, updates)
    mp.setattr(muon, "apply_updates", late)


FAULTS = [teacher_one_layer_early, no_position_bias, teacher_in_bfloat16, half_batch,
          updates_skipped_after_setup]
