"""Plain PyTorch reference of the content encoder's training step
(`trainers/asr_trainer.py` `_process_batch`, `:287-358`): the frozen
features of a batch (the w2v-BERT teacher's layer-17 states, `conformer.py`,
and the CAM++ style vector), the tokenizer's training forward with its
distillation head, the masked L1 to the teacher, the ASR decoder's
sequence-to-sequence cross-entropy over the Whisper text, their gradients
by autograd, and AdamW behind one clip of the global norm.

The parts it shares with the voice-conversion LM's reference are taken
from there: the ConvNeXt encoder, the window-limited transformer and the
pre-quantisation latents (`codec.py`), the causal layer stack (`lm.py`),
the fbank, resampling and norms (`nn.py`), CAM++ (`speaker.py`).

Departures from the upstream, each kept as the program keeps it:

- no straight-through estimator: the quantizer's sign passes no gradient,
  so neither loss reaches the backbone, the downsample, the pre-module or
  the LFQ's input projection (only AdamW's decoupled decay moves them);
- one clip of the global norm over the tokenizer and the ASR decoder
  together (the upstream clips each model by itself);
- float32 throughout the student, where the upstream trains under
  autocast; the teacher in the dtype of its weights (`conformer.py`);
- every frame of a padded batch is valid for the teacher and CAM++, and
  the L1 counts each row's own valid teacher frames.

The trained tree is a flat dict of float32 leaves keyed by their paths
(`flatten`: dict keys and list indices), in the program's layouts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import codec, conformer, lm, nn, speaker


def flatten(tree, prefix: Tuple = ()) -> Dict[Tuple, torch.Tensor]:
    """{path: leaf} of a nested tree of dicts and lists (list items under their indices)."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: Dict[Tuple, torch.Tensor]):
    """The nested tree of a flat dict: a node whose keys are all integers is a list."""
    root: Dict = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node

    return lists(root)


def teacher_lens(wave_lens, sample_rate: int, rate16: int) -> np.ndarray:
    """Each row's valid teacher frames: its samples at 16 kHz (the
    resampler's length, rounded up), +-160 samples of padding, 25 ms fbank
    frames every 10 ms, two to a row."""
    n16 = np.ceil(np.asarray(wave_lens, np.float64) * rate16 / sample_rate).astype(np.int64)
    frames = (n16 + 320 - 400) // 160 + 1
    return np.maximum(frames, 0) // 2


def frozen(trees: Dict, cfg, waves: torch.Tensor, layers: int, teacher: Optional[Dict] = None
           ) -> Dict:
    """The teacher's features and CAM++'s style vector (B, 192) of a padded
    batch of 44.1 kHz waves; `teacher` the conformer tree to run in place
    of `trees["teacher"]` (the control's, in bfloat16)."""
    w16 = nn.resample(waves, cfg.sample_rate, cfg.resample_rate)
    feats = conformer.teacher(teacher or trees["teacher"], cfg.teacher, w16, layers)
    fb = nn.fbank(w16)
    fb = fb - fb.mean(dim=1, keepdim=True)
    style = speaker.campplus(trees["campplus"], cfg.campplus, fb, fb.shape[1] // 2)
    return {"teacher_feats": feats, "style": style}


def bits_of(p: Dict, z, bits: int):
    """The LFQ's sign bits of pre-quantisation latents, as token indices (MSB first)."""
    return nn.lfq_encode(p["lfq"], z, bits)


def tokens(trees: Dict, cfg, waves) -> torch.Tensor:
    """The content tokens of the tokenizer's input side (B, T // 2048)."""
    p = trees["tokenizer"]
    z = codec.content_latents(p, cfg.tokenizer, waves)
    return bits_of(p, z, nn.bits_of(cfg.tokenizer.quantizer.codebook_size))


def quantized(p: Dict, cfg, idx):
    """Token indices (B, T') -> the quantized latents through the LFQ's output
    projection and the post-module: the +-1 bits over sqrt(bits)."""
    bits = nn.bits_of(cfg.quantizer.codebook_size)
    w = 2 ** torch.arange(bits - 1, -1, -1, device=idx.device)
    sign = ((idx.long()[..., None] & w) != 0).float() * 2.0 - 1.0
    zq = nn.linear(p["lfq"]["project_out"], sign / math.sqrt(bits))
    return codec.windowed_transformer(p["post_module"], cfg.transformer, zq)


def head(p: Dict, c, zq, target_len: int, g):
    """The distillation head: latents repeated to `target_len` frames by
    nearest neighbour (frame t takes latent floor(t T' / target_len)), the
    style added through `g_in`, then the ConvNeXt encoder."""
    src = torch.div(torch.arange(target_len, device=zq.device) * zq.shape[1], target_len,
                    rounding_mode="floor")
    x = zq[:, src]
    x = x + nn.linear(p["g_in"], g[:, None])
    return codec.convnext_encoder(p, c, x)


def s2s(p: Dict, a, audio, audio_lens, text, text_lens):
    """The ASR decoder's cross-entropy: each row's stream [its audio
    frames | bos, its text, eos], causal, the row of each of bos and the
    text predicting the next token; the mean over a row's predictions,
    then over the rows."""
    if "audio_proj" in p:
        audio = nn.linear(p["audio_proj"], audio)
    total = 0.0
    for b in range(audio.shape[0]):
        la, n = int(audio_lens[b]), int(text_lens[b])
        ids = torch.cat([torch.tensor([a.bos_id], device=audio.device), text[b, :n].long(),
                         torch.tensor([a.eos_id], device=audio.device)])
        x = torch.cat([audio[b, :la], p["text_embedding"][ids]])[None]
        h = lm._stack(p["layers"], x, a.num_heads, a.num_heads, a.hidden_dim // a.num_heads,
                      a.norm_eps, a.rope_base)
        h = nn.rms_norm(h[0, la:la + n + 1], p["norm"]["w"], a.norm_eps)
        logits = nn.linear(p["prediction_head"], h).float()
        total = total + F.cross_entropy(logits, ids[1:])
    return total / audio.shape[0]


def losses(flat: Dict, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L1, s2s) of a batch: `waves`' tokens `idx` (B, T'), `teacher_feats`
    (B, Tt, D) with `teacher_lens`, `style` (B, 192), `frame_lens`, `text`,
    `text_lens`."""
    tree = unflatten(flat)
    tok = tree["tokenizer"]
    zq = quantized(tok, cfg.tokenizer, batch["idx"])
    tf = batch["teacher_feats"]
    pred = head(tok["head"], cfg.tokenizer.head, zq, tf.shape[1], batch["style"])
    valid = (torch.arange(tf.shape[1], device=tf.device)[None, :]
             < batch["teacher_lens"][:, None]).float()[..., None]
    l1 = (torch.abs(pred - tf) * valid).sum() / (valid.sum() * tf.shape[-1]).clamp(min=1.0)
    ce = s2s(tree["asr"], cfg.asr_decoder, zq, batch["frame_lens"], batch["text"],
             batch["text_lens"])
    return l1, ce


def loss_grads(params: Dict, cfg, tcfg: Dict, batch: Dict):
    """((L1, s2s) as floats, the gradient of ce_weight s2s + l1_weight L1
    by leaf, zeros where the loss does not reach)."""
    for v in params.values():
        v.requires_grad_(True)
    l1, ce = losses(params, cfg, batch)
    loss = tcfg["ce_weight"] * ce + tcfg["l1_weight"] * l1
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    for v in params.values():
        v.requires_grad_(False)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}
    return (float(l1.detach()), float(ce.detach())), grads


def clipped(grads: Dict, clip: float) -> Dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if bool(norm < clip):
        return grads
    return {k: g / norm * clip for k, g in grads.items()}


class AdamW:
    """optax's adamw(lr, 0.9, 0.98, 1e-6, weight decay 0.01) behind
    clip_by_global_norm(clip), in place on a flat dict of leaves."""

    def __init__(self, params: Dict, tcfg: Dict, count: int = 0, mu=None, nu=None):
        self.lr, self.clip, self.count = tcfg["lr"], tcfg["clip"], count
        self.mu = {k: torch.zeros_like(p) if mu is None else mu[k].detach().clone().float()
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) if nu is None else nu[k].detach().clone().float()
                   for k, p in params.items()}

    def step(self, params: Dict, grads: Dict) -> None:
        grads = clipped(grads, self.clip)
        self.count += 1
        bc1, bc2 = 1.0 - 0.9 ** self.count, 1.0 - 0.98 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = 0.9 * self.mu[k] + 0.1 * g
                self.nu[k] = 0.98 * self.nu[k] + 0.02 * g * g
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-6)
                params[k].add_(-self.lr * (u + 0.01 * params[k]))
