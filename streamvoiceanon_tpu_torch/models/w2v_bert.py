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

The teacher holds its weights in `dtype`, float16 by default as the
upstream's frozen teacher (`asr_trainer.py:301-303`), float32 where asked;
the native weights are truncated to the first `layer` layers, the only
ones it runs.  Its features come out in float32 either way.

Calling the teacher on a padded batch with each row's samples gives the
features and each row's valid frames (`feature_lens`), the pair the
content-encoder trainer's L1 takes.  The whole padded batch runs as one,
as the JAX package's teacher runs it: no row's padding is masked in the
featurisation or the attention.  The class counts the rows, the frames
run (padding included) and the valid frames of these calls, which
`utils/profiling`'s export reads over a traced stretch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device


def feature_lens(lens16) -> np.ndarray:
    """The teacher's frames (50 a second) of rows of `lens16` samples at
    16 kHz, each padded by 160 samples on both sides: the 25 ms fbank
    frames every 10 ms, stacked two to one (a half-valid last pair left
    out)."""
    n = np.asarray(lens16, np.int64) + 320
    return np.maximum(1 + (n - 400) // 160, 0) // 2


class W2vBertTeacher:
    counts = {"rows": 0, "frames": 0, "valid_frames": 0}  # over every call, `__call__`

    def __init__(self, layer: int = 17, model_name: str = "facebook/w2v-bert-2.0",
                 native: bool = False, native_params: Optional[Dict] = None,
                 native_cfg=None, device=None, dtype: torch.dtype = torch.float16):
        self.layer = layer
        self.model_name = model_name
        self.native = native or native_params is not None
        self.device = resolve_device(device)
        self.dtype = dtype
        self._model = None
        self._processor = None
        self._native_params = None if native_params is None else self._held(native_params)
        self._native_cfg = native_cfg

    def _held(self, tree: Dict) -> Dict:
        """A port tree's first `layer` layers and its input side, in `dtype`
        on the teacher's device."""
        def cast(t):
            return t.detach().to(self.device, self.dtype if t.is_floating_point() else None)

        def first(x):
            if isinstance(x, dict):
                return {k: first(v) for k, v in x.items()}
            return cast(x[:self.layer])

        return {k: first(v) if k == "layers" else
                {n: cast(t) for n, t in v.items()} for k, v in tree.items()}

    def _load(self):
        if self._model is None:
            from transformers import AutoFeatureExtractor, Wav2Vec2BertModel

            self._processor = AutoFeatureExtractor.from_pretrained(self.model_name)
            self._model = Wav2Vec2BertModel.from_pretrained(self.model_name).eval().to(
                self.device, self.dtype)

    def _load_native(self):
        from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

        if self._native_cfg is None:
            self._native_cfg = wn.W2VBertConfig()
        if self._native_params is None:
            from transformers import Wav2Vec2BertModel

            from streamvoiceanon_tpu_torch.params import w2v_bert_params

            hf = Wav2Vec2BertModel.from_pretrained(self.model_name)
            self._native_params = self._held(w2v_bert_params(
                wn.convert(hf.state_dict(), self._native_cfg), self.device))
            del hf

    @torch.no_grad()
    def features(self, wav16k) -> torch.Tensor:
        """wav (B, T) at 16 kHz -> the layer-`layer` hidden states (B, T //
        320, 1024) float32 on the teacher's device, with the reference's
        +-160-sample padding; computed in the teacher's dtype."""
        wav = torch.as_tensor(np.asarray(wav16k, np.float32) if not torch.is_tensor(wav16k)
                              else wav16k).to(self.device, torch.float32)
        wav = torch.nn.functional.pad(wav, (160, 160))
        if self.native:
            from streamvoiceanon_tpu_torch.models import w2v_bert_native as wn

            self._load_native()
            feats, mask = wn.stacked_features(wav)
            return wn.apply(self._native_params, self._native_cfg, feats, mask=mask,
                            num_layers=self.layer).float()
        self._load()
        inputs = self._processor([w for w in wav.cpu().numpy()], sampling_rate=16000,
                                 return_tensors="pt", padding=True)
        inputs = {k: v.to(self.device, self.dtype if v.is_floating_point() else None)
                  for k, v in inputs.items()}
        out = self._model(**inputs, output_hidden_states=True)
        return out.hidden_states[self.layer].float()

    def __call__(self, wav16k, lens16) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features (B, T', 1024) float32, each row's valid frames (B,)
        int64 on the teacher's device) of a padded batch at 16 kHz whose
        rows hold `lens16` samples (host integers)."""
        feats = self.features(wav16k)
        lens = np.minimum(feature_lens(lens16), feats.shape[1])
        c = W2vBertTeacher.counts
        c["rows"] += feats.shape[0]
        c["frames"] += feats.shape[0] * feats.shape[1]
        c["valid_frames"] += int(lens.sum())
        return feats, torch.from_numpy(lens).to(self.device)
