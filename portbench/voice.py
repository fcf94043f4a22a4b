"""Seeded synthetic speech and the utterance-length laws of the traffic mixes.

`synthetic_voice` is a copy of the port's `chip_smoke.synthetic_voice` at
commit b084fe3: five harmonics of a slowly gliding f0 under a
syllable-rate envelope, plus noise, at 44.1 kHz.  Every random number comes
from numpy's `default_rng` of a seed derived from the run's seed and the
utterance's index (`sub_seed`), so the same run seed gives the same audio
and seeds of any size (more than 32 bits) work.

`lengths` reads a length law from a traffic file: the quantiles of a
log-normal between a floor and a ceiling, in a fixed interleaved order, so
that every seed gets the same set of lengths in the same order and any
prefix of the list is spread over the whole law.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def sub_seed(seed: int, *index: int) -> int:
    """A 63-bit seed for (seed, index...): distinct for each and the same in every process."""
    return int(np.random.SeedSequence([int(seed) % (2 ** 64), *index]).generate_state(
        1, np.uint64)[0] >> 1)


def synthetic_voice(seconds: float, f0: float, seed: int, sample_rate: int = 44100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n) / float(sample_rate)
    f = f0 * (1.0 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f) / float(sample_rate)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6.28)) ** 2
    wav = sum(np.sin(h * phase + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    return (0.1 * env * wav + 0.005 * rng.standard_normal(n)).astype(np.float32)


def voice(seconds: float, seed: int, index: int, sample_rate: int = 44100) -> np.ndarray:
    """Utterance `index` of a run: its f0 (90 to 250 Hz) and audio from the seed."""
    s = sub_seed(seed, index)
    f0 = float(np.random.default_rng(s).uniform(90.0, 250.0))
    return synthetic_voice(seconds, f0, s + 1, sample_rate)


def _interleaved(n: int) -> List[int]:
    """0..n-1 in bit-reversed order: every prefix covers the range evenly."""
    bits = max(1, (n - 1).bit_length())
    rev = sorted(range(1 << bits), key=lambda i: int(f"{i:0{bits}b}"[::-1], 2))
    return [i for i in rev if i < n]


def lengths(law: Dict) -> List[float]:
    """`law`: {"count", "mean_s", "sigma", "min_s", "max_s"} -> `count`
    utterance lengths in seconds, the midpoint quantiles of a log-normal
    with that mean and log-sd, clipped to [min_s, max_s], interleaved."""
    from statistics import NormalDist

    n, sigma = int(law["count"]), float(law["sigma"])
    mu = np.log(float(law["mean_s"])) - sigma ** 2 / 2
    q = [float(np.exp(mu + sigma * NormalDist().inv_cdf((i + 0.5) / n))) for i in range(n)]
    q = [min(max(x, float(law["min_s"])), float(law["max_s"])) for x in q]
    return [q[i] for i in _interleaved(n)]
