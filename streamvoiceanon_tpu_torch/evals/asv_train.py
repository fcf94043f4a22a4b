"""ASV_eval^anon with the CAM++ backbone: a speaker-verification model
retrained on anonymized speech, as the JAX package's evals/asv_train.py.

The informed attacker of the VPC protocol (eval_post) adapts a speaker
embedding to anonymized speech with an additive-angular-margin softmax
over the training speakers, on random 3 s chunks.  Here the backbone is
CAM++ (frozen, BatchNorm on its stored statistics, unless
`finetune_backbone`) under a trainable residual projection; the centred
embedding's running mean is kept for inference.

A step is autograd on the device with AdamW written to optax's numerics
(`train/muon.adamw`: counts from 1, eps outside the root, decay on every
trained leaf).  Batches are drawn with numpy (`_chunk_batch`), so a seed
gives the JAX package's batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import CAMPPlusConfig
from streamvoiceanon_tpu_torch.evals.anonymize import fbank_features, to_16k, tree_device
from streamvoiceanon_tpu_torch.models import campplus
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map


@dataclasses.dataclass
class ASVTrainConfig:
    chunk_seconds: float = 3.0          # sentence_len in the speechbrain recipe
    sample_rate: int = 16000
    batch_size: int = 32
    steps: int = 200
    lr: float = 1e-3
    margin: float = 0.2                 # AAM-softmax additive angular margin
    scale: float = 30.0                 # AAM-softmax scale
    emb_dim: int = 192
    finetune_backbone: bool = False     # False: train the projection and centres only
    weight_decay: float = 1e-4
    seed: int = 0


def init_head(generator: torch.Generator, cfg: ASVTrainConfig, n_speakers: int) -> Dict:
    """The projection (identity plus 1e-3 noise), its bias, the AAM class
    centres and the running embedding mean, on the generator's device."""
    dev, D = generator.device, cfg.emb_dim
    proj_w = torch.randn((D, D), generator=generator, device=dev) * 1e-3
    return {
        "proj_w": proj_w + torch.eye(D, device=dev),
        "proj_b": torch.zeros((D,), device=dev),
        "centers": torch.randn((n_speakers, D), generator=generator, device=dev)
        * float(1.0 / np.sqrt(D)),
        "emb_mean": torch.zeros((D,), device=dev),
    }


def embed(params: Dict, cp_cfg: CAMPPlusConfig, feat: torch.Tensor,
          feat_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adapted embedding (B, emb_dim): CAM++ -> projection -> less the
    running mean."""
    e = campplus.apply(params["backbone"], cp_cfg, feat, feat_lens)
    e = e @ params["head"]["proj_w"] + params["head"]["proj_b"]
    return e - params["head"]["emb_mean"]


def aam_softmax_loss(head: Dict, emb: torch.Tensor, labels: torch.Tensor,
                     margin: float, scale: float) -> torch.Tensor:
    """Additive-angular-margin softmax: cos(theta_y + m) for the target
    class, scaled cross-entropy over the cosine logits.  Where theta_y + m
    passes pi the target logit is cos(theta_y) - m sin(m) (the easy-margin
    guard), and sin(theta_y) is clamped to at least 1e-3, as in JAX."""
    e = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
    c = head["centers"]
    c = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-8)
    cos = e @ c.t()  # (B, S)
    cos_y = cos.gather(1, labels[:, None].long())[:, 0]
    sin_y = torch.sqrt(torch.clamp(1.0 - cos_y ** 2, 1e-6, 1.0))
    cos_margin = cos_y * float(np.cos(margin)) - sin_y * float(np.sin(margin))
    cos_margin = torch.where(cos_y > float(-np.cos(margin)), cos_margin,
                             cos_y - float(margin * np.sin(margin)))
    target = F.one_hot(labels.long(), cos.shape[1]).bool()
    logits = torch.where(target, cos_margin[:, None], cos) * scale
    return F.cross_entropy(logits, labels.long())


def _chunk_batch(rng: np.random.Generator, wavs: List[np.ndarray],
                 labels: np.ndarray, cfg) -> Tuple[np.ndarray, np.ndarray]:
    """A batch of random fixed-length chunks and their labels, drawn with
    numpy exactly as the JAX package draws them."""
    n_samp = int(cfg.chunk_seconds * cfg.sample_rate)
    idx = rng.integers(len(wavs), size=cfg.batch_size)
    out = np.zeros((cfg.batch_size, n_samp), np.float32)
    for row, i in enumerate(idx):
        w = wavs[i]
        if len(w) <= n_samp:
            out[row, : len(w)] = w
        else:
            s = rng.integers(len(w) - n_samp)
            out[row] = w[s : s + n_samp]
    return out, labels[idx]


def training_set(utterances: Sequence, utt_sample_rate: int, sample_rate: int,
                 device) -> Tuple[List[np.ndarray], np.ndarray, int]:
    """(wavs resampled to `sample_rate` as float32 numpy, speaker labels in
    sorted speaker order, the number of speakers)."""
    speakers = sorted({u.speaker for u in utterances})
    spk_index = {s: i for i, s in enumerate(speakers)}
    wavs = [resample_np(u.wav, utt_sample_rate, sample_rate, device) for u in utterances]
    return wavs, np.asarray([spk_index[u.speaker] for u in utterances], np.int32), len(speakers)


def resample_np(wav: np.ndarray, sr: int, new_sr: int, device) -> np.ndarray:
    from streamvoiceanon_tpu_torch.audio.resample import resample

    w = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    return resample(w, sr, new_sr)[0].cpu().numpy().astype(np.float32)


def adamw_step(tx: muon.GradientTransformation, opt_state, trained: Dict,
               loss: torch.Tensor):
    """One optax-style AdamW step on the leaves of `trained` (which require
    grad), in place: gradients (zeros where the loss does not reach a leaf),
    the update, p += u.  Returns the optimizer state."""
    flat = flatten(trained)
    gs = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(flat.items(), gs)}
    updates, opt_state = tx.update(grads, opt_state, {k: p.detach() for k, p in flat.items()})
    muon.apply_updates(flat, updates)
    return opt_state


def leaves(tree: Dict) -> Dict:
    """A float32 copy of a tree whose leaves require grad."""
    return tree_map(lambda t: t.detach().float().clone().requires_grad_(True), tree)


def batch_loss(backbone: Dict, head: Dict, cp_cfg: CAMPPlusConfig, cfg: ASVTrainConfig,
               feat: torch.Tensor, lens: torch.Tensor, labels: torch.Tensor):
    """(the AAM loss of a batch of fbank features, the batch's mean
    embedding): the embedding is centred on the batch mean, which is held
    constant (the running mean applies at inference)."""
    e = campplus.apply(backbone, cp_cfg, feat, lens)
    e = e @ head["proj_w"] + head["proj_b"]
    batch_mean = e.mean(dim=0).detach()
    return aam_softmax_loss(head, e - batch_mean, labels, cfg.margin, cfg.scale), batch_mean


def train_asv_eval(
    campplus_params: Dict,
    cp_cfg: CAMPPlusConfig,
    utterances: Sequence,               # evals.anonymize.Utterance, anonymized
    cfg: ASVTrainConfig = ASVTrainConfig(),
    utt_sample_rate: int = 44100,
    history: Optional[list] = None,
) -> Dict:
    """The trained {'backbone', 'head'} on the device of `campplus_params`,
    for `embed` / `extract_embeddings` in the AA scoring.  Each step's AAM
    loss is appended to `history` when given."""
    dev = tree_device(campplus_params)
    wavs, labels, n_spk = training_set(utterances, utt_sample_rate, cfg.sample_rate, dev)
    head = init_head(torch.Generator(device=dev).manual_seed(cfg.seed), cfg, n_spk)
    emb_mean = head.pop("emb_mean")  # a running statistic, not optimised
    backbone = campplus_params
    trained = {"head": leaves(head)}
    if cfg.finetune_backbone:
        trained["backbone"] = leaves(campplus_params)
        backbone = trained["backbone"]
    tx = muon.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = tx.init(flatten(trained))
    rng = np.random.default_rng(cfg.seed)
    losses = []
    for _ in range(cfg.steps):
        wav_b, lab_b = _chunk_batch(rng, wavs, labels, cfg)
        feat, lens = fbank_features(torch.from_numpy(wav_b).to(dev))
        loss, batch_mean = batch_loss(backbone, trained["head"], cp_cfg, cfg, feat, lens,
                                      torch.from_numpy(lab_b).to(dev))
        opt_state = adamw_step(tx, opt_state, trained, loss)
        emb_mean = 0.9 * emb_mean + 0.1 * batch_mean
        losses.append(loss.detach())
    out = tree_map(lambda t: t.detach(), trained)
    out.setdefault("backbone", campplus_params)
    out["head"]["emb_mean"] = emb_mean
    if history is not None:
        history.extend(float(x) for x in losses)
    return out


@torch.no_grad()
def extract_embeddings(params: Dict, cp_cfg: CAMPPlusConfig, utterances: Sequence,
                       sample_rate: int = 44100, center: bool = True) -> np.ndarray:
    """Adapted embeddings (N, emb_dim) for scoring, the ASV_eval^anon
    counterpart of `evals.anonymize.speaker_embeddings`; with `center` less
    the set's own mean."""
    dev = tree_device(params["head"])
    out = []
    for u in utterances:
        feat, lens = fbank_features(to_16k(u.wav, sample_rate, dev))
        out.append(embed(params, cp_cfg, feat, lens)[0].cpu().numpy())
    embs = np.stack(out)
    if center:
        embs = embs - embs.mean(axis=0)
    return embs
