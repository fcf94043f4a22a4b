"""ARVC (voice-conversion LM) trainer, as the JAX package's
train/arvc_trainer.py.

Per batch the frozen feature extractors give the codec targets, the
content conditions and the speaker embeddings (`_features`); the dual-AR
LM is trained with the codebook and semantic CEs under MuonAdamW with the
exponential-decay schedule and gradient clipping (`_step`); metrics go to
`metrics.jsonl` and, where it imports, tensorboard; checkpoints are
torch-native (`runtime/checkpoints.py`'s format), one directory
`ckpt_{step}` each.

The delay of a batch is drawn uniformly from `cfg.arvc.decoder.delay` with
a `torch.Generator` seeded from `TrainerConfig.seed` (its draws need not
equal JAX's).  The parameters are updated in place, so the decode kernels
that `log_audio_sample` runs read the trained values.

Distribution (`parallel/mesh.py`): the trainer runs on the mesh of the
initialized process group, `n_model_shards` ranks to a model group and data
over what is left of the world (one process, no process group: the 1 x 1
mesh).  The frozen extractors are replicated; the LM is sharded by
`dual_ar_param_specs`; every rank is given the whole host batch and keeps
its rows over 'data'.  The delays are drawn alike on every rank (one seed).
Metrics and checkpoints are written by rank 0; a checkpoint is the gathered
tree in the one-device format, so it does not depend on the shard count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.audio.resample import resample
from streamvoiceanon_tpu_torch.config import PipelineConfig
from streamvoiceanon_tpu_torch.models import (arvc, campplus, speaker_encoder, tokenizer,
                                              vocoder)
from streamvoiceanon_tpu_torch.parallel import mesh as meshlib
from streamvoiceanon_tpu_torch.runtime.checkpoints import PACKED, load_tree, save_tree
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.train import step as step_mod
from streamvoiceanon_tpu_torch.utils.profiling import span
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 1e-4
    gamma: float = 0.999997
    min_lr: float = 1e-5
    clip: float = 1000.0
    codebook_loss_weight: float = 1.0
    semantic_loss_weight: float = 1.0
    log_interval: int = 10
    save_interval: int = 4000
    log_dir: str = "runs/arvc"
    seed: int = 0
    n_model_shards: int = 1


def _ckpt_step(name: str) -> Optional[int]:
    tail = name.split("_", 1)[1] if name.startswith("ckpt_") else ""
    return int(tail) if tail.isdigit() else None


class ARVCTrainer:
    """Trains a copy of `arvc_params` (a port tree) in float32; the other
    trees stay frozen.  Runs on `device`, the card unless given."""

    def __init__(self, cfg: PipelineConfig, tcfg: TrainerConfig, arvc_params: Dict,
                 tokenizer_params: Dict, vocoder_params: Dict,
                 campplus_params: Optional[Dict] = None,
                 speaker_params: Optional[Dict] = None, device: Optional[str] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = meshlib.make_mesh(n_model=tcfg.n_model_shards, device=self.device)
        self.lead = self.mesh.rank == 0

        def frozen(tree):
            if tree is None:
                return None
            tree = {k: v for k, v in tree.items() if k not in PACKED}
            return tree_map(lambda t: t.detach().to(self.device), tree)

        self.frozen = {"tokenizer": frozen(tokenizer_params), "vocoder": frozen(vocoder_params),
                       "campplus": frozen(campplus_params), "speaker": frozen(speaker_params)}
        self.specs = meshlib.dual_ar_param_specs(arvc_params)
        params = meshlib.shard_params(
            step_mod.trainable(tree_map(lambda t: t.to(self.device), arvc_params)),
            self.mesh, self.specs, cfg.arvc)
        self.shards = muon.Shards(meshlib.leaf_shards(self.specs),
                                  self.mesh.model_group)
        schedule = muon.exp_decay_schedule(tcfg.lr, tcfg.gamma, tcfg.min_lr)
        self.optimizer = muon.chain(muon.clip_by_global_norm(tcfg.clip, self.shards),
                                    muon.muon_adamw(lr=tcfg.lr, shards=self.shards),
                                    muon.scale_by_schedule(schedule))
        self.state = step_mod.init_state(params, self.optimizer)
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        self.metrics_path = os.path.join(tcfg.log_dir, "metrics.jsonl")
        os.makedirs(tcfg.log_dir, exist_ok=True)
        self._tb = None
        self._has_tb = False
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._has_tb = True
            self._tb = SummaryWriter(tcfg.log_dir) if self.lead else None
        except Exception:
            pass

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _features(self, waves, frame_lens, shard: bool = True) -> Dict:
        """Frozen feature extraction of waves (B, T) at 44.1 kHz and their
        valid frames: content tokens (also the semantic targets), codec
        codes, the CAM++ style vector over the mean-normalised fbank of the
        16 kHz audio (lengths half its frames), the speaker encoder's timbre
        latents; zeros where a tree is absent.  On a mesh (`shard`): of
        this rank's rows of the batch."""
        waves = torch.as_tensor(np.asarray(waves, np.float32)
                                if not torch.is_tensor(waves) else waves)
        frame_lens = torch.as_tensor(np.asarray(frame_lens))
        if shard:
            waves, frame_lens = meshlib.shard_batch((waves, frame_lens), self.mesh)
        waves = waves.to(self.device, torch.float32)
        B = waves.shape[0]
        w16 = resample(waves, self.cfg.sample_rate, self.cfg.resample_rate)
        content = tokenizer.encode(self.frozen["tokenizer"], self.cfg.tokenizer, waves)
        codes = vocoder.encode(self.frozen["vocoder"], self.cfg.vocoder, waves)[0]
        if self.frozen["campplus"] is not None:
            style = campplus.style_of(self.frozen["campplus"], self.cfg.campplus, w16)
        else:
            style = torch.zeros((B, self.cfg.arvc.style_dim), device=self.device)
        if self.frozen["speaker"] is not None:
            lens16 = torch.full((B,), w16.shape[1], dtype=torch.int32, device=self.device)
            timbre = speaker_encoder.tokenize_wav(self.frozen["speaker"], self.cfg.speaker, w16,
                                                  lens16)[0]
        else:
            timbre = torch.zeros((B, 32, self.cfg.arvc.context_dim), device=self.device)
        return {"content": content, "base_target": content, "target": codes,
                "x_lens": frame_lens.to(self.device, torch.int32),
                "style": style, "timbre": timbre}

    def _step(self, features: Dict, delay: int) -> Dict:
        """One optimizer step on a feature batch (this rank's rows) at
        `delay`.  Returns the whole batch's loss, two CEs and raw
        gradients' norm as device scalars."""
        self.state, aux = step_mod.train_step(
            self.state, features, self.cfg.arvc, self.optimizer, delay,
            (self.tcfg.codebook_loss_weight, self.tcfg.semantic_loss_weight),
            self.mesh.data_group, self.shards)
        return aux

    def draw_delay(self) -> int:
        delays = self.cfg.arvc.decoder.delay
        return int(delays[int(torch.randint(len(delays), (), generator=self.generator))])

    def train_step(self, batch: Dict) -> Dict:
        """One step on a host batch with `waves` (B, T) and `frame_lens`:
        with the recorder on (`utils/profiling.tracing`) the span
        `train_step`, its stages `features`, `step.train_step`'s `fwd_bwd`
        and `optim`, and `sync` (the host's wait for the aux scalars)."""
        with span("train_step"):
            with span("features"):
                feats = self._features(batch["waves"], batch["frame_lens"])
            aux = self._step(feats, self.draw_delay())
            with span("sync"):
                return {k: float(v) for k, v in aux.items()}

    # ------------------------------------------------------------------

    def train(self, data: Iterator[Dict], max_steps: int = 1000) -> None:
        t0 = time.time()
        for i, batch in enumerate(data):
            if i >= max_steps:
                break
            aux = self.train_step(batch)
            step = self.state.step
            if step % self.tcfg.log_interval == 0 and self.lead:
                rec = dict(aux, step=step, wall=time.time() - t0)
                with open(self.metrics_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if self._tb is not None:
                    for k, v in aux.items():
                        self._tb.add_scalar(f"train/{k}", v, step)
            if step % self.tcfg.save_interval == 0:
                self.save_checkpoint()

    # ------------------------------------------------------------------

    def gathered_params(self) -> Dict:
        """The whole parameter tree, gathered from the model group's shards
        (every rank of the group takes part)."""
        return meshlib.gather_params(self.state.params, self.mesh, self.specs, self.cfg.arvc)

    def save_checkpoint(self, path: Optional[str] = None, keep_last: int = 1) -> str:
        """The whole parameters under `path` (`log_dir/ckpt_{step}` unless
        given), written by rank 0 (every rank takes part in the gather),
        then only the newest `keep_last` `ckpt_{step}` directories kept."""
        base = os.path.abspath(self.tcfg.log_dir)
        path = path or os.path.join(base, f"ckpt_{self.state.step}")
        tree = self.gathered_params()
        if not self.lead:
            return path
        os.makedirs(path, exist_ok=True)
        save_tree(tree, os.path.join(path, "arvc.pt"))
        if keep_last:
            old = sorted((d for d in os.listdir(base) if _ckpt_step(d) is not None),
                         key=_ckpt_step)[:-keep_last]
            for d in old:
                shutil.rmtree(os.path.join(base, d), ignore_errors=True)
        return path

    def load_checkpoint(self, path: str) -> None:
        """The parameters from `path`, copied into the trained tensors; the
        step from the directory's name (0 if it has none).  The optimizer
        state is kept as it is, as the JAX trainer keeps it."""
        restored = flatten(meshlib.shard_params(
            load_tree(os.path.join(path, "arvc.pt"), self.device), self.mesh, self.specs,
            self.cfg.arvc))
        with torch.no_grad():
            for k, p in flatten(self.state.params).items():
                p.copy_(restored[k])
        tail = path.rstrip("/").rsplit("_", 1)[-1]
        self.state = self.state._replace(step=int(tail) if tail.isdigit() else 0)

    def resume_latest(self) -> Optional[str]:
        """Resume from the highest-step `ckpt_{step}` in log_dir."""
        base = os.path.abspath(self.tcfg.log_dir)
        cands = ([d for d in os.listdir(base) if _ckpt_step(d) is not None]
                 if os.path.isdir(base) else [])
        if not cands:
            return None
        path = os.path.join(base, max(cands, key=_ckpt_step))
        self.load_checkpoint(path)
        return path

    def log_audio_sample(self, batch: Dict, step: Optional[int] = None) -> None:
        """Reconstruction logging: `arvc.generate` of the batch's first
        utterance (its first 16 frames as the prompt) on the trained
        weights, vocoded, to tensorboard (every rank of a mesh computes it,
        rank 0 writes it)."""
        if not self._has_tb:
            return
        params = tree_map(lambda t: t.detach(), self.state.params)
        with torch.inference_mode():
            feats = self._features(batch["waves"][:1], batch["frame_lens"][:1], shard=False)
            codes = arvc.generate(
                params, self.cfg.arvc, feats["content"][:, :16], feats["target"][:, :, :16],
                feats["content"], feats["style"], feats["timbre"],
                generator=torch.Generator(device=self.device).manual_seed(0))
            wav = vocoder.decode(self.frozen["vocoder"], self.cfg.vocoder, codes)
        if self._tb is None:
            return
        self._tb.add_audio("train/reconstruction", wav[0, :, None].float().cpu().numpy(),
                           step if step is not None else self.state.step,
                           sample_rate=self.cfg.sample_rate)
