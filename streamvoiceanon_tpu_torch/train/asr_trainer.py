"""The content-encoder (ASR) trainer on one device, as the JAX package's
train/asr_trainer.py: the tokenizer (with its post-quantization transformer
and distillation head) and the ASR decoder trained together on

* the masked L1 distance of the head's prediction to the frozen w2v-BERT
  teacher's layer-17 features, and
* the ASR decoder's sequence-to-sequence CE over the quantized latents
  and the Whisper-tokenized text,

under `chain(clip_by_global_norm(10), adamw(lr, 0.9, 0.98, 1e-6, wd 0.01))`
(`train/muon.py`'s optax pieces).  Two findings of the JAX package kept
here as they are:

* the clip is one global norm over both models together (the JAX code;
  its comment says "per model");
* the quantizer has no straight-through estimator (`lfq_quantize` takes
  the sign), so neither loss reaches the backbone, the downsample,
  `pre_module` or `lfq.project_in`: their gradients are exactly zero and
  only AdamW's decoupled decay moves them.

A batch either comes prepared (`teacher_feats`, `teacher_lens`,
`latent_lens`) or straight from `train.data.batches` (`waves` at 44.1
kHz, `wave_lens`, `frame_lens`, `text`, `text_lens`).  For the latter the
trainer computes the frozen features itself, as the upstream's step
(`asr_trainer.py:287-358`) does, under `torch.no_grad`: the teacher's
features and each row's valid frames of the 16 kHz audio from `teacher`
(a `models/w2v_bert.W2vBertTeacher`, float16 and truncated at layer 17 by
default), and, given `campplus_params`, the CAM++ style vector the head
takes as `g`, as `ARVCTrainer._features` computes it
(`campplus.style_of`).  `teacher_fn(waves, wave_lens) -> (feats, lens)`,
the JAX package's entry for the teacher (44.1 kHz in, as its parity
tests feed it), takes the teacher's place where given.  The parameters
are updated in place on `device`, the card unless given.  Sharding over
several cards waits for the port of parallel/mesh.py.

With the recorder on (`utils/profiling.tracing`) a step is the span
`train_step` over `features` (and inside it `teacher` and `style`, where
the trainer computes them), `fwd_bwd`, `optim` and `sync` (the host's wait
for the losses).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.audio.resample import resample
from streamvoiceanon_tpu_torch.config import PipelineConfig, TokenizerConfig
from streamvoiceanon_tpu_torch.models import asr_decoder, campplus, tokenizer
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.train import step as step_mod
from streamvoiceanon_tpu_torch.utils.profiling import span
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map

KEEP = ("waves", "teacher_feats", "teacher_lens", "latent_lens", "text", "text_lens", "style")


@dataclasses.dataclass
class ASRTrainerConfig:
    lr: float = 1e-4
    clip: float = 10.0  # one global norm over both models (see the module note)
    ce_weight: float = 1.0
    l1_weight: float = 1.0


def head_l1(head: Dict, cfg: TokenizerConfig, latents: torch.Tensor,
            teacher_feats: torch.Tensor, teacher_lens: torch.Tensor,
            g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked L1 distance of the head's prediction from the post-module
    `latents` (`tokenizer.head_prediction`) to the teacher's features, over
    the first `teacher_lens` frames of each row and every channel."""
    pred = tokenizer.head_prediction(head, cfg, latents, teacher_feats.shape[1], g)
    mask = (torch.arange(pred.shape[1], device=pred.device)[None, :]
            < teacher_lens[:, None]).to(pred.dtype)[..., None]
    return torch.sum(torch.abs(pred - teacher_feats) * mask) / torch.clamp(
        torch.sum(mask) * pred.shape[-1], min=1.0)


def loss_fn(params: Dict, cfg: PipelineConfig, acfg: asr_decoder.ASRDecoderConfig,
            tcfg: ASRTrainerConfig, batch: Dict):
    """(ce_weight * s2s + l1_weight * l1, {"s2s_loss", "l1_loss"}) of a
    prepared batch of tensors on the parameters' device."""
    zq, _ = tokenizer.quantized_latents(params["tokenizer"], cfg.tokenizer, batch["waves"])
    l1 = head_l1(params["tokenizer"]["head"], cfg.tokenizer, zq, batch["teacher_feats"],
                 batch["teacher_lens"], batch.get("style"))
    s2s = asr_decoder.forward(params["asr"], acfg, zq, batch["latent_lens"], batch["text"],
                              batch["text_lens"])
    return tcfg.ce_weight * s2s + tcfg.l1_weight * l1, {"s2s_loss": s2s, "l1_loss": l1}


class ASRTrainer:
    def __init__(self, cfg: PipelineConfig, acfg: asr_decoder.ASRDecoderConfig,
                 tcfg: ASRTrainerConfig, tokenizer_params: Dict, asr_params: Dict,
                 teacher_fn: Optional[Callable] = None, device=None, *,
                 teacher: Optional[Callable] = None, campplus_params: Optional[Dict] = None):
        """`tokenizer_params` a port tree with its head
        (`params.tokenizer_params(..., with_head=True)`), `asr_params` one of
        `params.asr_decoder_params`; both are copied, in float32, to
        `device`.  `teacher(wav16k, lens16) -> (feats, lens)` (a
        `W2vBertTeacher`) and `campplus_params` give a dataloader batch its
        frozen features; `teacher_fn(waves, wave_lens)` on the 44.1 kHz
        batch, the JAX package's contract, stands for `teacher` where
        given."""
        self.cfg, self.acfg, self.tcfg = cfg, acfg, tcfg
        self.teacher_fn, self.teacher = teacher_fn, teacher
        self.device = resolve_device(device)
        self.campplus = None if campplus_params is None else tree_map(
            lambda t: t.detach().to(self.device), campplus_params)
        self.params = step_mod.trainable(
            tree_map(lambda t: t.to(self.device),
                     {"tokenizer": tokenizer_params, "asr": asr_params}))
        self.optimizer = muon.chain(
            muon.clip_by_global_norm(tcfg.clip),
            muon.adamw(tcfg.lr, b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01))
        self.opt_state = self.optimizer.init(flatten(self.params))
        self.step_count = 0

    @torch.no_grad()
    def frozen_features(self, waves, wave_lens) -> Dict:
        """The frozen features of a padded batch of 44.1 kHz `waves` (B, T)
        whose rows hold `wave_lens` samples: the teacher's features and
        each row's valid frames of the 16 kHz audio (`teacher_feats`,
        `teacher_lens`; spans `teacher`), and where the trainer has CAM++
        the style vector as the head's `g` (B, 1, embedding_size) (`style`;
        span `style`).  `teacher_fn`, where given, is handed the batch as
        a float32 tensor on the device."""
        waves = torch.as_tensor(np.asarray(waves, np.float32)
                                if not torch.is_tensor(waves) else waves)
        waves = waves.to(self.device, torch.float32)
        sr, sr16 = self.cfg.sample_rate, self.cfg.resample_rate
        w16 = resample(waves, sr, sr16)
        lens16 = -(-np.asarray(wave_lens, np.int64) * sr16 // sr)  # resample's ceil
        out = {}
        with span("teacher"):
            out["teacher_feats"], out["teacher_lens"] = (
                self.teacher_fn(waves, wave_lens) if self.teacher_fn is not None
                else self.teacher(w16, lens16))
        if self.campplus is not None:
            with span("style"):
                out["style"] = campplus.style_of(self.campplus, self.cfg.campplus, w16)[:, None]
        return out

    def prepare(self, batch: Dict) -> Dict:
        """A host or dataloader batch -> the step's tensors on the device:
        latent lengths default to the frame lengths, the frozen features
        (`frozen_features`) are computed where the batch has none."""
        def dev(v):
            t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            return t.to(self.device, torch.float32) if t.is_floating_point() else t.to(self.device)

        batch = dict(batch)
        if "latent_lens" not in batch and "frame_lens" in batch:
            batch["latent_lens"] = batch["frame_lens"]
        if "teacher_feats" not in batch:
            if self.teacher_fn is None and self.teacher is None:
                raise ValueError("batch lacks teacher_feats and the trainer has neither a "
                                 "teacher nor a teacher_fn")
            batch["waves"] = dev(batch["waves"])  # moved once, for the frozen models and the step
            batch = {**self.frozen_features(batch["waves"], batch["wave_lens"]), **batch}
        return {k: dev(v) for k, v in batch.items() if k in KEEP}

    def step(self, batch: Dict) -> Dict:
        """One optimizer step on a prepared batch: the loss, the two terms
        and the raw gradients' global norm as device scalars, and the
        gradients by path (`grads`); spans `fwd_bwd` and `optim`."""
        with span("fwd_bwd"):
            loss, aux = loss_fn(self.params, self.cfg, self.acfg, self.tcfg, batch)
            grads = step_mod.grads_of(loss, self.params)
        with span("optim"):
            flat = flatten(self.params)
            with torch.no_grad():
                updates, self.opt_state = self.optimizer.update(grads, self.opt_state, flat)
                muon.apply_updates(flat, updates)
            self.step_count += 1
            return {**{k: v.detach() for k, v in aux.items()}, "loss": loss.detach(),
                    "grad_norm": muon.global_norm(grads), "grads": grads}

    def train_step(self, batch: Dict) -> Dict:
        """One step on a prepared or dataloader batch; the losses as floats."""
        with span("train_step"):
            with span("features"):
                batch = self.prepare(batch)
            aux = self.step(batch)
            with span("sync"):
                return {k: float(aux[k]) for k in ("s2s_loss", "l1_loss", "loss")}
