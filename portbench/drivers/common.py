"""What the drivers share: the converter from a configuration file and a
seed, the reference's copy of the same weights, the Gumbel noise of a
seeded generator, and the comparison helpers."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import core, weights
from portbench.reference import nn as rnn


def dtypes(config: Dict) -> Dict[str, torch.dtype]:
    dt = config["dtypes"]
    return {"arvc": core.DTYPES[dt["lm"]], "tokenizer": core.DTYPES[dt["dsp"]],
            "vocoder": core.DTYPES[dt["dsp"]]}


def draw_trees(config: Dict, seed: int, device) -> Dict[str, Dict]:
    """The five weight trees at the configuration's widths, on the card, from the seed."""
    p = config["pipeline"]
    specs = {"tokenizer": weights.tokenizer(p["tokenizer"]), "vocoder": weights.vocoder(p["vocoder"]),
             "arvc": weights.arvc(p["arvc"]), "campplus": weights.campplus(p["campplus"]),
             "speaker": weights.speaker(p["speaker"])}
    return weights.draw(specs, seed, device, dtypes(config))


def converter(config: Dict, trees: Dict, device):
    """The port's converter over the benchmark's trees (its public constructor),
    on the device the port's own entry points resolve, which also pins full
    float32 precision for matrix products and convolutions."""
    from streamvoiceanon_tpu_torch import resolve_device
    from streamvoiceanon_tpu_torch.params import Converter

    return Converter(cfg=core.port_config(config["pipeline"]),
                     tokenizer_params=trees["tokenizer"], vocoder_params=trees["vocoder"],
                     arvc_params=trees["arvc"], device=resolve_device(device),
                     campplus_params=trees["campplus"], speaker_params=trees["speaker"])


def reference_trees(trees: Dict) -> Dict:
    """The reference's float32 copy of the benchmark's trees."""
    return {k: weights.cast(v, torch.float32) for k, v in trees.items()}


def fp8_round(tree):
    """Every matrix of a tree rounded through float8 e4m3 with a per-tensor
    scale (amax to 448), back in float32: the control's LM weights."""
    if isinstance(tree, dict):
        return {k: fp8_round(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_round(v) for v in tree]
    if tree.ndim < 2:
        return tree
    scale = tree.abs().amax().clamp(min=1e-30) / 448.0
    return (tree / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """-log(-log(U)) of uniform draws of a generator on the card."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of elements that differ."""
    if a.shape != b.shape:
        return 1.0
    return float((a.to(b.device).long() != b.long()).float().mean())


def rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref|| (float64)."""
    x, ref = x.double().to(ref.device), ref.double()
    if x.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref).clamp(min=1e-300))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """Each number beside its limit; ok where it is at most the limit."""
    out = []
    for k, lim in limits.items():
        v = numbers.get(k, float("inf"))
        v = float(v) if v == v else float("inf")
        out.append({"name": k, "value": v, "limit": float(lim), "ok": v <= lim})
    return out


def no_tf32():
    rnn.no_tf32()


def peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
