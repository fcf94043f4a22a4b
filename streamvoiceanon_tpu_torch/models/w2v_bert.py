"""The frozen w2v-BERT 2.0 teacher of the content encoder's distillation, as
the JAX package's models/w2v_bert.py: the hidden states of layer 17 (of
24) of `facebook/w2v-bert-2.0` for 16 kHz audio padded by 160 samples on
each side (50 frames a second).

Two paths, as there: `native=True` runs the port's conformer
(`models/w2v_bert_native.py`) on its own featurisation, with weights given
as a port tree (`native_params`) or converted once from the published HF
checkpoint; otherwise the HF module itself runs with its feature
extractor.  Loading the checkpoint needs `transformers` and the published
files, imported and read only when a path needs them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device


class W2vBertTeacher:
    def __init__(self, layer: int = 17, model_name: str = "facebook/w2v-bert-2.0",
                 native: bool = False, native_params: Optional[Dict] = None,
                 native_cfg=None, device=None):
        self.layer = layer
        self.model_name = model_name
        self.native = native or native_params is not None
        self.device = resolve_device(device)
        self._model = None
        self._processor = None
        self._native_params = native_params
        self._native_cfg = native_cfg

    def _load(self):
        if self._model is None:
            from transformers import AutoFeatureExtractor, Wav2Vec2BertModel

            self._processor = AutoFeatureExtractor.from_pretrained(self.model_name)
            self._model = Wav2Vec2BertModel.from_pretrained(self.model_name).eval().to(
                self.device)

    def _load_native(self):
        from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

        if self._native_cfg is None:
            self._native_cfg = wn.W2VBertConfig()
        if self._native_params is None:
            from transformers import Wav2Vec2BertModel

            from streamvoiceanon_tpu_torch.params import w2v_bert_params

            hf = Wav2Vec2BertModel.from_pretrained(self.model_name)
            self._native_params = w2v_bert_params(
                wn.convert(hf.state_dict(), self._native_cfg), self.device)
            del hf

    @torch.no_grad()
    def features(self, wav16k) -> torch.Tensor:
        """wav (B, T) at 16 kHz -> the layer-`layer` hidden states (B, T //
        320, 1024) float32 on the teacher's device, with the reference's
        +-160-sample padding."""
        wav = torch.as_tensor(np.asarray(wav16k, np.float32) if not torch.is_tensor(wav16k)
                              else wav16k).to(self.device, torch.float32)
        wav = torch.nn.functional.pad(wav, (160, 160))
        if self.native:
            from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

            self._load_native()
            feats, mask = wn.stacked_features(wav)
            return wn.apply(self._native_params, self._native_cfg, feats, mask=mask,
                            num_layers=self.layer)
        self._load()
        inputs = self._processor([w for w in wav.cpu().numpy()], sampling_rate=16000,
                                 return_tensors="pt", padding=True)
        out = self._model(**{k: v.to(self.device) for k, v in inputs.items()},
                          output_hidden_states=True)
        return out.hidden_states[self.layer].float()
