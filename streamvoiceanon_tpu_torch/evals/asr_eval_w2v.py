"""ASR_eval^w2v: the conformer CTC recogniser that scores utility (WER), as
the JAX package's evals/asr_eval_w2v.py: the w2v-BERT conformer
(`models/w2v_bert_native.py`) on its stacked-fbank features (50 frames a
second) with a character-CTC head, trained on the evaluation data with two
AdamW groups, the encoder's learning rate scaled by `encoder_lr_scale`.

Two operating points: the default tiny conformer trained from a random
start, and `W2VASRConfig.full()`, the published 24 x 1024 geometry, whose
encoder can start from the published weights (`from_hf_encoder`); the head
is always trained on the evaluation data.  The vocabulary helpers and the
greedy decode are the compact recogniser's (`evals/asr_eval_train.py`).
Plain PyTorch on `device` (the card unless given).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.evals.asr_eval_train import (ctc_mean, build_vocab, encode_text,
                                                            greedy_ctc_decode, labels_of, to_rate)
from streamvoiceanon_tpu_torch.evals.asv_train import adamw_step, leaves
from streamvoiceanon_tpu_torch.models import w2v_bert_native as w2v
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map


@dataclasses.dataclass
class W2VASRConfig:
    encoder: w2v.W2VBertConfig = dataclasses.field(
        default_factory=lambda: w2v.W2VBertConfig(
            hidden=144, n_layers=2, n_heads=4, intermediate=288, conv_kernel=15))
    steps: int = 300
    batch_size: int = 8
    lr: float = 1e-3
    encoder_lr_scale: float = 1.0  # < 1 when fine-tuning pretrained weights
    max_frames: int = 256          # padded 50 Hz stacked-feature frames
    max_label_len: int = 128
    sample_rate: int = 16000
    seed: int = 0

    @staticmethod
    def full() -> "W2VASRConfig":
        """The published w2v-BERT 2.0 geometry (conformer 24 x 1024)."""
        return W2VASRConfig(encoder=w2v.W2VBertConfig(), encoder_lr_scale=0.05, lr=3e-4)


def init_asr_params(generator: torch.Generator, cfg: W2VASRConfig, vocab_size: int,
                    encoder_params: Optional[Dict] = None) -> Dict:
    """The encoder (random, or `encoder_params`, a port tree) and a fresh
    He-normal CTC head over the vocabulary and the blank."""
    dev, H = generator.device, cfg.encoder.hidden
    enc = encoder_params if encoder_params is not None else w2v.init_params(
        generator, cfg.encoder)
    w = torch.randn((H, vocab_size + 1), generator=generator, device=dev) * float(
        np.sqrt(2.0 / H))
    return {"encoder": enc, "ctc": {"w": w, "b": torch.zeros(vocab_size + 1, device=dev)}}


def from_hf_encoder(state_dict: Dict, generator: torch.Generator, cfg: W2VASRConfig,
                    vocab_size: int) -> Dict:
    """Published Wav2Vec2BertModel weights -> recogniser parameters with a
    fresh head, on the generator's device."""
    from streamvoiceanon_tpu_torch.params import w2v_bert_params

    enc = w2v_bert_params(w2v.convert(state_dict, cfg.encoder), generator.device)
    return init_asr_params(generator, cfg, vocab_size, encoder_params=enc)


def forward(params: Dict, cfg: W2VASRConfig, feats: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """feats (B, T, 160), mask (B, T) -> CTC logits (B, T, V + 1)."""
    h = w2v.apply(params["encoder"], cfg.encoder, feats, mask)
    return h @ params["ctc"]["w"] + params["ctc"]["b"]


def _feature_batch(wavs, cfg: W2VASRConfig, max_frames: int,
                   device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """The padded stacked-fbank batch (the teacher's featurisation) and its
    int32 mask."""
    out = np.zeros((len(wavs), max_frames, cfg.encoder.feat_dim), np.float32)
    mask = np.zeros((len(wavs), max_frames), np.int32)
    for i, w in enumerate(wavs):
        f, m = w2v.stacked_features(torch.as_tensor(w, dtype=torch.float32, device=device)[None])
        f, m = f[0].cpu().numpy(), m[0].cpu().numpy()
        n = min(int(m.sum()), max_frames)
        out[i, :n] = f[:n]
        mask[i, :n] = 1
    return out, mask


def optimizer(cfg: W2VASRConfig) -> muon.GradientTransformation:
    """AdamW on the encoder at lr * encoder_lr_scale, AdamW on the head at lr."""
    return muon.multi_transform(
        {"enc": muon.adamw(cfg.lr * cfg.encoder_lr_scale, weight_decay=1e-5),
         "head": muon.adamw(cfg.lr, weight_decay=1e-5)},
        lambda flat: {k: "enc" if k[0] == "encoder" else "head" for k in flat})


def train_asr_eval_w2v(
    utterances: Sequence,            # evals.anonymize.Utterance
    texts: Dict[str, str],           # utt_id -> transcript
    cfg: Optional[W2VASRConfig] = None,
    utt_sample_rate: int = 16000,
    encoder_params: Optional[Dict] = None,
    history: Optional[list] = None,
    device=None,
) -> Tuple[Dict, Dict[str, int]]:
    """Trains the conformer CTC recogniser on `device` (the card unless
    given); returns (params, vocab).  `encoder_params` (a port tree, e.g.
    from `w2v.convert` through `params.w2v_bert_params`) fine-tunes it."""
    if cfg is None:
        cfg = W2VASRConfig()
    dev = resolve_device(device)
    vocab = build_vocab([texts[u.utt_id] for u in utterances])
    wavs = [to_rate(u.wav, utt_sample_rate, cfg.sample_rate, dev) for u in utterances]
    lab, lab_pad = labels_of([encode_text(texts[u.utt_id], vocab) for u in utterances],
                             cfg.max_label_len)
    feats, masks = _feature_batch(wavs, cfg, cfg.max_frames, dev)
    data = [torch.from_numpy(a).to(dev) for a in (feats, masks, lab, lab_pad)]
    params = leaves(init_asr_params(torch.Generator(device=dev).manual_seed(cfg.seed), cfg,
                                    len(vocab), encoder_params=encoder_params))
    tx = optimizer(cfg)
    opt_state = tx.init(flatten(params))
    rng = np.random.default_rng(cfg.seed)
    n = len(wavs)
    losses = []
    for _ in range(cfg.steps):
        idx = torch.from_numpy(rng.integers(n, size=min(cfg.batch_size, n))).to(dev)
        f, m, y, ypad = (a[idx] for a in data)
        loss = ctc_mean(forward(params, cfg, f, m), m, y, ypad)
        opt_state = adamw_step(tx, opt_state, params, loss)
        losses.append(loss.detach())
    if history is not None:
        history.extend(float(x) for x in losses)
    return tree_map(lambda t: t.detach(), params), vocab


def make_transcriber_w2v(params: Dict, vocab: Dict[str, int],
                         cfg: Optional[W2VASRConfig] = None) -> Callable:
    """`transcriber(wav, sr) -> text` for `evals.wer.evaluate_asr`, on the
    parameters' device; features padded to a 64-frame (1.28 s) bucket."""
    if cfg is None:
        cfg = W2VASRConfig()
    dev = params["ctc"]["w"].device

    @torch.no_grad()
    def transcriber(wav: np.ndarray, sr: int) -> str:
        w = to_rate(wav, sr, cfg.sample_rate, dev)
        bucket = int(np.ceil(max(len(w) // 320, 1) / 64)) * 64
        feats, mask = _feature_batch([w], cfg, bucket, dev)
        logits = forward(params, cfg, torch.from_numpy(feats).to(dev),
                         torch.from_numpy(mask).to(dev))
        return greedy_ctc_decode(logits[0].cpu().numpy(), mask[0].astype(bool), vocab)

    return transcriber
