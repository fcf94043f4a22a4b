"""ASR_eval: the compact character-CTC recogniser that scores utility (WER),
trained on the evaluation data, as the JAX package's evals/asr_eval_train.py:
Kaldi fbank (mean-normalised per utterance) -> two stride-2 convs (kernel
3, `padding="SAME"`: (0, 1) on an even length, (1, 1) on an odd one) ->
sinusoidal positions -> a non-causal pre-LN transformer encoder (tanh
GELU, as `jax.nn.gelu`) -> CTC logits over the characters plus blank.
Training is AdamW on `optax.ctc_loss` (`ops/ctc.py`), each loss divided by
its label length; batches are drawn with numpy exactly as the JAX package
draws them.  The transcriber it returns plugs into `evals.wer.evaluate_asr`.

Plain PyTorch on `device` (the card unless given): the JAX package trains
it outside any Pallas kernel.  `init_params` draws on a `torch.Generator`
with the JAX package's distributions (not its draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.audio import fbank as fbank_mod
from streamvoiceanon_tpu_torch.audio.resample import resample
from streamvoiceanon_tpu_torch.evals.asv_train import adamw_step, leaves
from streamvoiceanon_tpu_torch.ops.ctc import ctc_loss
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map

BLANK = 0


@dataclasses.dataclass
class ASREvalConfig:
    feat_dim: int = 80
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    ffn_mult: int = 4
    subsample: int = 4           # two stride-2 convs
    steps: int = 400
    batch_size: int = 8
    lr: float = 1e-3
    max_frames: int = 512        # padded feature frames (pre-subsample)
    max_label_len: int = 128
    sample_rate: int = 16000
    seed: int = 0


def build_vocab(texts: Sequence[str]) -> Dict[str, int]:
    """Char vocab; id 0 is the CTC blank."""
    chars = sorted({c for t in texts for c in t})
    return {c: i + 1 for i, c in enumerate(chars)}


def encode_text(text: str, vocab: Dict[str, int]) -> List[int]:
    return [vocab[c] for c in text if c in vocab]


def decode_ids(ids: Sequence[int], vocab: Dict[str, int]) -> str:
    inv = {i: c for c, i in vocab.items()}
    return "".join(inv.get(i, "") for i in ids)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ASREvalConfig, vocab_size: int) -> Dict:
    """He-normal linears and convs (PyTorch's (out, in, k)), zero biases,
    identity LayerNorms, on the generator's device."""
    dev = generator.device
    rn = lambda *s, std: torch.randn(s, generator=generator, device=dev) * std
    zeros = lambda n: torch.zeros(n, device=dev)

    def lin(din, dout):
        return {"w": rn(din, dout, std=float(np.sqrt(2.0 / din))), "b": zeros(dout)}

    def layer():
        return {"qkv": lin(cfg.dim, 3 * cfg.dim), "out": lin(cfg.dim, cfg.dim),
                "ff1": lin(cfg.dim, cfg.ffn_mult * cfg.dim),
                "ff2": lin(cfg.ffn_mult * cfg.dim, cfg.dim),
                "ln1": {"g": torch.ones(cfg.dim, device=dev), "b": zeros(cfg.dim)},
                "ln2": {"g": torch.ones(cfg.dim, device=dev), "b": zeros(cfg.dim)}}

    return {
        "conv1": {"w": rn(cfg.dim, cfg.feat_dim, 3, std=float(np.sqrt(2.0 / (3 * cfg.feat_dim)))),
                  "b": zeros(cfg.dim)},
        "conv2": {"w": rn(cfg.dim, cfg.dim, 3, std=float(np.sqrt(2.0 / (3 * cfg.dim)))),
                  "b": zeros(cfg.dim)},
        "layers": [layer() for _ in range(cfg.n_layers)],
        "out": lin(cfg.dim, vocab_size + 1),
    }


def _ln(p, x):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * p["g"] + p["b"]


def same_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, T, C_in) -> (B, ceil(T / stride), C_out): XLA's "SAME" padding,
    the odd row of padding after the sequence."""
    T, k = x.shape[1], w.shape[-1]
    total = max((-(-T // stride) - 1) * stride + k - T, 0)
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return F.conv1d(h, w, b, stride=stride).transpose(1, 2)


def forward(params: Dict, cfg: ASREvalConfig, feat: torch.Tensor,
            feat_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B, T, 80), mask (B, T) bool -> (logits (B, T / 4, V + 1), out mask)."""
    x = feat
    for cname in ("conv1", "conv2"):
        x = F.relu(same_conv(x, params[cname]["w"], params[cname]["b"], 2))
        feat_mask = feat_mask[:, ::2]
    B, T, _ = x.shape
    dev = x.device
    inv = torch.pow(10000.0, torch.arange(0, cfg.dim, 2, device=dev, dtype=torch.float32)
                    / cfg.dim)
    pos = torch.arange(T, device=dev, dtype=torch.float32)[:, None] / inv
    pe = torch.stack([torch.sin(pos), torch.cos(pos)], dim=-1).reshape(T, cfg.dim)
    x = x + pe[None]
    bias = torch.where(feat_mask[:, None, None, :], 0.0, -1e9)
    H = cfg.n_heads
    hd = cfg.dim // H
    heads = lambda t: t.reshape(B, T, H, hd).transpose(1, 2)
    for lp in params["layers"]:
        q, k, v = torch.chunk(_ln(lp["ln1"], x) @ lp["qkv"]["w"] + lp["qkv"]["b"], 3, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        a = torch.softmax(q @ k.transpose(-1, -2) / float(np.sqrt(hd)) + bias, -1)
        h = (a @ v).transpose(1, 2).reshape(B, T, cfg.dim)
        x = x + h @ lp["out"]["w"] + lp["out"]["b"]
        h = F.gelu(_ln(lp["ln2"], x) @ lp["ff1"]["w"] + lp["ff1"]["b"], approximate="tanh")
        x = x + h @ lp["ff2"]["w"] + lp["ff2"]["b"]
    return x @ params["out"]["w"] + params["out"]["b"], feat_mask


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _features(wavs: List[np.ndarray], cfg: ASREvalConfig, max_frames: Optional[int] = None,
              device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Padded fbank batch (B, max_frames, 80), each utterance less its mean
    frame, and its mask; `max_frames` defaults to the training window."""
    if max_frames is None:
        max_frames = cfg.max_frames
    out = np.zeros((len(wavs), max_frames, cfg.feat_dim), np.float32)
    mask = np.zeros((len(wavs), max_frames), bool)
    for i, w in enumerate(wavs):
        f = fbank_mod.fbank(torch.as_tensor(w, dtype=torch.float32, device=device)[None])[0]
        f = (f - f.mean(dim=0, keepdim=True)).cpu().numpy()
        n = min(len(f), max_frames)
        out[i, :n] = f[:n]
        mask[i, :n] = True
    return out, mask


def labels_of(labels: List[List[int]], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Right-padded label ids (N, max_len) and their paddings (1.0 = pad)."""
    lab = np.zeros((len(labels), max_len), np.int32)
    pad = np.ones((len(labels), max_len), np.float32)
    for i, seq in enumerate(labels):
        n = min(len(seq), max_len)
        lab[i, :n] = seq[:n]
        pad[i, :n] = 0.0
    return lab, pad


def ctc_mean(logits: torch.Tensor, out_mask: torch.Tensor, y: torch.Tensor,
             ypad: torch.Tensor) -> torch.Tensor:
    """The batch mean of each CTC loss over its label length."""
    per = ctc_loss(logits, 1.0 - out_mask.float(), y, ypad, blank_id=BLANK)
    return torch.mean(per / torch.clamp(torch.sum(1.0 - ypad, dim=-1), min=1.0))


def to_rate(wav: np.ndarray, sr: int, rate: int, device) -> np.ndarray:
    w = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    return resample(w, sr, rate)[0].cpu().numpy()


def train_asr_eval(
    utterances: Sequence,            # evals.anonymize.Utterance
    texts: Dict[str, str],           # utt_id -> transcript
    cfg: ASREvalConfig = ASREvalConfig(),
    utt_sample_rate: int = 16000,
    history: Optional[list] = None,
    device=None,
) -> Tuple[Dict, Dict[str, int]]:
    """Trains the CTC recogniser on `device` (the card unless given);
    returns (params, vocab).  Each step's loss is appended to `history`."""
    dev = resolve_device(device)
    vocab = build_vocab([texts[u.utt_id] for u in utterances])
    wavs = [to_rate(u.wav, utt_sample_rate, cfg.sample_rate, dev) for u in utterances]
    lab, lab_pad = labels_of([encode_text(texts[u.utt_id], vocab) for u in utterances],
                             cfg.max_label_len)
    feats, masks = _features(wavs, cfg, device=dev)
    data = [torch.from_numpy(a).to(dev) for a in (feats, masks, lab, lab_pad)]
    params = leaves(init_params(torch.Generator(device=dev).manual_seed(cfg.seed), cfg,
                                len(vocab)))
    tx = muon.adamw(cfg.lr, weight_decay=1e-5)
    opt_state = tx.init(flatten(params))
    rng = np.random.default_rng(cfg.seed)
    n = len(wavs)
    losses = []
    for _ in range(cfg.steps):
        idx = torch.from_numpy(rng.integers(n, size=min(cfg.batch_size, n))).to(dev)
        f, m, y, ypad = (a[idx] for a in data)
        logits, om = forward(params, cfg, f, m)
        loss = ctc_mean(logits, om, y, ypad)
        opt_state = adamw_step(tx, opt_state, params, loss)
        losses.append(loss.detach())
    if history is not None:
        history.extend(float(x) for x in losses)
    return tree_map(lambda t: t.detach(), params), vocab


def greedy_ctc_decode(logits: np.ndarray, mask: np.ndarray, vocab: Dict[str, int]) -> str:
    """Best-path decode: collapse repeats, drop blanks."""
    ids = np.argmax(logits, axis=-1)
    out = []
    prev = -1
    for i, t in zip(ids, mask):
        if not t:
            break
        if i != prev and i != BLANK:
            out.append(int(i))
        prev = i
    return decode_ids(out, vocab)


def make_transcriber(params: Dict, vocab: Dict[str, int],
                     cfg: ASREvalConfig = ASREvalConfig()) -> Callable:
    """`transcriber(wav, sr) -> text` for `evals.wer.evaluate_asr`, on the
    parameters' device; the fbank frames padded to a 128-frame bucket, so
    no audio is cut."""
    dev = params["out"]["w"].device

    @torch.no_grad()
    def transcriber(wav: np.ndarray, sr: int) -> str:
        w = to_rate(wav, sr, cfg.sample_rate, dev)
        bucket = int(np.ceil(max(len(w) // 160, 1) / 128)) * 128
        feats, mask = _features([w], cfg, max_frames=bucket, device=dev)
        logits, om = forward(params, cfg, torch.from_numpy(feats).to(dev),
                             torch.from_numpy(mask).to(dev))
        return greedy_ctc_decode(logits[0].cpu().numpy(), om[0].cpu().numpy(), vocab)

    return transcriber
