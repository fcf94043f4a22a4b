"""Text utilities for training-data preparation.

Covers the reference text_utils package (SURVEY.md §2.2): transcript
cleaning + repetition filtering (text_utils/clean.py:25-48) and a compact
Chinese text normalization pass (numbers/dates/percent/money/phone — the
capabilities of text_utils/chn_text_norm/, re-expressed).

The port's own copy of `streamvoiceanon_tpu.utils.text`.
"""

from __future__ import annotations

import re
from collections import Counter

_SYMBOL_MAP = {"‘": "'", "’": "'"}
_SYMBOL_RE = re.compile("|".join(re.escape(k) for k in _SYMBOL_MAP))
_EMOJI_RE = re.compile(
    "["
    "\U0001F600-\U0001F64F"
    "\U0001F300-\U0001F5FF"
    "\U0001F680-\U0001F6FF"
    "\U0001F1E0-\U0001F1FF"
    "]+",
    flags=re.UNICODE,
)


def clean_text(text: str) -> str:
    """Strip, map curly quotes, drop emojis, collapse repeated commas."""
    text = text.strip()
    text = _SYMBOL_RE.sub(lambda m: _SYMBOL_MAP[m.group()], text)
    text = _EMOJI_RE.sub("", text)
    text = re.sub(r"[,]{2,}", lambda m: m.group()[0], text)
    return text


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """True if any length-`length` pattern repeats more than `tolerance`
    times (loopy-ASR transcript filter)."""
    counts = Counter(text[i : i + length] for i in range(len(text) - length + 1))
    return any(c > tolerance for c in counts.values())


# ---------------------------------------------------------------------------
# Chinese text normalization (digits -> spoken form)
#
# The full reference-parity implementation lives in utils/cn_norm.py
# (fuzz-tested against the importable text_utils/chn_text_norm package);
# these are the stable public entry points.
# ---------------------------------------------------------------------------

from streamvoiceanon_tpu_torch.utils.cn_norm import (  # noqa: E402
    digits_to_cn,
    normalize_cn_text,
    num_to_cn,
)


def number_to_chinese(n: int) -> str:
    """Integer -> Chinese cardinal (e.g. 10203 -> 一万零二百零三)."""
    if n < 0:
        return "负" + number_to_chinese(-n)
    return num_to_cn(str(n))


def digits_to_chinese(s: str) -> str:
    """Digit-by-digit reading (telephone numbers, 编号)."""
    return digits_to_cn("".join(c for c in s if c.isdigit()))


def normalize_chinese(text: str) -> str:
    """Normalize numeric patterns in Chinese text to spoken form —
    reference-exact (text_utils/chn_text_norm/text.py:1-177)."""
    return normalize_cn_text(text)
