"""Transcript -> token-id pipeline for ASR-trainer data, the port's own copy
of `streamvoiceanon_tpu.train.text`.

The reference's PseudoDataset.process_text
(dataloaders/hf_stream_dataloader.py:163-241): strip -> repetition filter
(length 4, tolerance 15, on punctuation-stripped text) -> clean_text ->
Chinese normalization for zh -> WhisperTokenizer ids.

The Whisper vocabulary requires the HF checkpoint files; when they are not
cached locally (a machine without network access) a deterministic UTF-8 byte fallback
keeps the whole training path runnable in the same id space (byte ids
0..255 < n_vocab 51866), framed with the ASR decoder's bos/eos.
"""

from __future__ import annotations

import string
from typing import List, Optional

from streamvoiceanon_tpu_torch.utils.text import (
    clean_text,
    normalize_chinese,
    repetition_found,
)

_PUNCTUATION = set(';:,.!?¡¿—…"«»“”' + string.punctuation)


class TextTokenizer:
    """Whisper tokenizer when its files are cached locally; otherwise a
    deterministic UTF-8 byte tokenizer in the same id space."""

    def __init__(
        self,
        name: str = "openai/whisper-small",
        bos_id: int = 50258,  # whisper <|startoftranscript|>
        eos_id: int = 50257,  # whisper <|endoftext|> (collate pad value,
        #                       hf_stream_dataloader.py:258)
    ):
        self.bos_id = bos_id
        self.eos_id = eos_id
        self._tok = None
        try:  # local cache only — never hit the network from a data worker
            from transformers import WhisperTokenizer

            self._tok = WhisperTokenizer.from_pretrained(
                name, task="transcribe", local_files_only=True
            )
            self.eos_id = self._tok.eos_token_id
        except Exception:
            pass

    @property
    def backend(self) -> str:
        return "whisper" if self._tok is not None else "bytes"

    def encode(self, text: str) -> List[int]:
        if self._tok is not None:
            return list(self._tok(text).input_ids)
        return [self.bos_id] + list(text.encode("utf-8")) + [self.eos_id]


def process_text(
    text: str,
    language: str = "en-us",
    tokenizer: Optional[TextTokenizer] = None,
) -> List[int]:
    """Clean/normalize/tokenize one transcript
    (hf_stream_dataloader.py:226-241).  Raises ValueError on loopy-ASR
    repetition so streaming callers can skip the sample."""
    lang = {"en": "en-us", "fr-fr": "fr", "dutch": "nl", "zh": "zh-CN"}.get(
        language, language
    )
    text = text.strip()
    text_wo_punct = "".join(c for c in text if c not in _PUNCTUATION)
    if repetition_found(text_wo_punct, length=4, tolerance=15):
        raise ValueError("repetition found in text")
    cleaned = clean_text(text)
    if lang == "zh-CN":
        cleaned = normalize_chinese(cleaned)
    if tokenizer is None:
        tokenizer = TextTokenizer()
    return tokenizer.encode(cleaned)
