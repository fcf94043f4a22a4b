"""Plain PyTorch reference of the voice-conversion LM's training step: the
frozen features of a batch, the two cross-entropies, their gradients by
autograd, and the optimizer chain (clip by global norm, MuonAdamW, the
exponential-decay schedule).

Frozen copy of the port's plain paths at commit b084fe3:
`streamvoiceanon_tpu_torch/train/arvc_trainer.py` `_features` and
`draw_delay`, `models/arvc.py` and `models/dual_ar.py` `forward_train`
(without recompute), `train/step.py` `loss_fn`, `train/muon.py`
(`clip_by_global_norm`, `adamw`, `muon`, `muon_adamw`'s routing,
`scale_by_schedule`, `exp_decay_schedule`).  Departures: one process, no
shards; the tree is a flat dict of float32 leaves keyed by their paths.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import codec, lm, nn, speaker

Path = Tuple[str, ...]


def flatten(tree, prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: Dict[Path, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def features(trees: Dict, cfg, waves, frame_lens) -> Dict:
    """Content tokens (and semantic targets), codec codes, style and timbre
    of a padded batch of 44.1 kHz waves (B, T)."""
    w16 = nn.resample(waves, cfg.sample_rate, cfg.resample_rate)
    content, _ = codec.content_tokens(trees["tokenizer"], cfg.tokenizer, waves)
    codes = codec.codec_encode(trees["vocoder"], cfg.vocoder, waves)
    feat = nn.fbank(w16)
    feat = (feat - feat.mean(dim=1, keepdim=True)).to(trees["campplus"]["tdnn_conv"].dtype)
    style = speaker.campplus(trees["campplus"], cfg.campplus, feat, feat.shape[1] // 2).float()
    timbre = speaker.timbre(trees["speaker"], cfg.speaker,
                            w16.to(trees["campplus"]["tdnn_conv"].dtype)).float()
    return {"content": content, "target": codes, "x_lens": frame_lens, "style": style,
            "timbre": timbre}


def losses(p: Dict, d, f: Dict, delay: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codebook CE, semantic CE) of a feature batch at `delay`."""
    m = p["model"]
    cond = p["embedding"][f["content"].long()]
    B, T, D = cond.shape
    dev = cond.device
    x_lens = f["x_lens"].to(dev).long()
    Tm = T + delay
    t_idx = torch.arange(Tm, device=dev)
    if delay > 0:
        tail = p["wait4end"][(t_idx[None, :] - x_lens[:, None]).clamp(0, delay - 1)]
    else:
        tail = torch.zeros((B, Tm, D), device=dev)
    cond_stream = torch.where((t_idx[None, :] < x_lens[:, None])[..., None],
                              F.pad(cond, (0, 0, 0, delay)), tail)
    audio = torch.cat([p["wait4start"][None, :delay].expand(B, -1, -1),
                       lm.embed_codes(m, d, f["target"])], dim=1)
    seq = torch.cat([lm.spk_condition(p, f["style"], f["timbre"]),
                     torch.stack([cond_stream, audio], dim=2).reshape(B, 2 * Tm, D)], dim=1)
    nl = lm._local(d.n_local_heads, d.n_head)
    x = lm._stack(m["layers"], seq, d.n_head, nl, d.head_dim, d.norm_eps, d.rope_base)
    S = seq.shape[1] - 2 * Tm
    lat = x[:, S + 2 * delay + 2 * torch.arange(T, device=dev)]
    valid = (torch.arange(T, device=dev)[None, :] < x_lens[:, None]).float()
    n_valid = valid.sum().clamp(min=1.0)

    def ce(logits, tgt):
        logits = logits.float()
        return torch.logsumexp(logits, -1) - torch.gather(logits, -1, tgt.long()[..., None])[..., 0]

    h = nn.rms_norm(lat, m["norm"]["w"], d.norm_eps)
    tok = (ce(h @ m["output"]["w"], f["content"]) * valid).sum() / n_valid
    nq = d.num_codebooks
    cb = f["target"].transpose(1, 2).long()
    fin = torch.cat([lat[:, :, None], m["fast_embeddings"][cb[..., :-1]]], dim=2)
    fnl = lm._local(d.fast_n_local_heads, d.fast_n_head)
    hf = lm._stack(m["fast_layers"], fin.reshape(B * T, nq, d.fast_dim), d.fast_n_head, fnl,
                   d.fast_head_dim, d.norm_eps, d.rope_base)
    hf = nn.rms_norm(hf, m["fast_norm"]["w"], d.norm_eps)
    logits = (hf @ m["fast_output"]["w"]).reshape(B, T, nq, d.codebook_size)
    cbl = (ce(logits, cb) * valid[..., None]).sum() / (n_valid * nq).clamp(min=1.0)
    return cbl, tok


EXCLUDE = ("embedding", "lm_head", "output", "to_logits")


def is_muon(path: Path, shape) -> bool:
    if any(ex in k for k in path for ex in EXCLUDE):
        return False
    return len([s for s in shape if s != 1]) >= 2


def newton_schulz5(g, steps: int = 6):
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    tr = x.shape[-2] > x.shape[-1]
    if tr:
        x = x.transpose(-1, -2)
    x = x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)), min=1e-7)
    for _ in range(steps):
        A = x @ x.transpose(-1, -2)
        x = a * x + (b * A + c * (A @ A)) @ x
    return x.transpose(-1, -2) if tr else x


class Optimizer:
    """clip_by_global_norm(clip) -> MuonAdamW -> exponential-decay schedule."""

    def __init__(self, params: Dict[Path, torch.Tensor], tcfg: Dict):
        self.t = tcfg
        self.count = 0
        self.mom = {k: torch.zeros_like(p) for k, p in params.items() if is_muon(k, p.shape)}
        self.mu = {k: torch.zeros_like(p) for k, p in params.items() if k not in self.mom}
        self.nu = {k: torch.zeros_like(v) for k, v in self.mu.items()}

    @classmethod
    def resume(cls, params: Dict[Path, torch.Tensor], tcfg: Dict, count: int, state: Dict):
        """The optimizer after `count` steps, its moments those of a MuonAdamW
        state (`{"muon": {"momentum"}, "adamw": {"mu", "nu"}}`)."""
        opt = cls(params, tcfg)
        opt.count = count
        opt.mom = {k: state["muon"]["momentum"][k].detach().clone().float() for k in opt.mom}
        opt.mu = {k: state["adamw"]["mu"][k].detach().clone().float() for k in opt.mu}
        opt.nu = {k: state["adamw"]["nu"][k].detach().clone().float() for k in opt.nu}
        return opt

    def step(self, params: Dict[Path, torch.Tensor], grads: Dict[Path, torch.Tensor]):
        t = self.t
        lr = t["lr"]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not bool(norm < t["clip"]):
            grads = {k: g / norm * t["clip"] for k, g in grads.items()}
        f32 = np.float32
        sched = float(np.maximum(f32(lr) * f32(t["gamma"]) ** f32(self.count), f32(t["min_lr"]))
                      / f32(lr))
        n = self.count + 1
        bc1 = float(f32(1) - f32(0.9) ** f32(n))
        bc2 = float(f32(1) - f32(0.98) ** f32(n))
        with torch.no_grad():
            for k, g in grads.items():
                p = params[k]
                if k in self.mom:
                    b = self.mom[k]
                    self.mom[k] = b + 0.05 * (g - b)
                    eff = g + 0.95 * (self.mom[k] - g)
                    shape = eff.shape
                    if eff.ndim > 3:
                        eff = eff.reshape(shape[0], shape[1], -1)
                    o = newton_schulz5(eff)
                    u = -lr * float(max(o.shape[-2], o.shape[-1])) ** 0.5 * o.reshape(shape)
                    u = u - lr * 0.01 * p
                else:
                    self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
                    self.nu[k] = 0.02 * (g * g) + 0.98 * self.nu[k]
                    u = -lr * ((self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-6)
                               + 0.01 * p)
                p.add_(float(f32(sched)) * u)
        self.count += 1


def delays(seed: int, choices: List[int], n: int) -> List[int]:
    """The trainer's delay draws: uniform over `choices` from a CPU
    generator seeded with the trainer's seed."""
    g = torch.Generator().manual_seed(seed)
    return [int(choices[int(torch.randint(len(choices), (), generator=g))]) for _ in range(n)]
