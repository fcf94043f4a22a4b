"""Training input pipeline, the port's own copy of
`streamvoiceanon_tpu.train.data` (numpy only).

Mirrors the reference dataloader capabilities
(dataloaders/hf_stream_dataloader.py): HF `datasets` streaming of
Emilia-style tar shards with per-process sharding, a local-directory dataset,
exception-skipping, probabilistic multi-corpus mixing, and length-sorted
padded collation — plus a synthetic source for tests and smoke runs.

Each process loads its own shard (`process_index` of `process_count` in
`emilia_stream`); the trainer moves the collated numpy batch to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

try:  # optional; streaming needs network access
    import datasets as hf_datasets
except Exception:  # pragma: no cover
    hf_datasets = None


@dataclasses.dataclass
class DataConfig:
    sample_rate: int = 44100
    min_duration: float = 1.0
    max_duration: float = 45.0
    batch_size: int = 8
    seed: int = 0
    shuffle_buffer: int = 5000


def skip_errors(it: Iterable, max_consecutive: int = 100) -> Iterator:
    """ExceptionHandlingWrapper (hf_stream_dataloader.py:17-31): swallow and
    skip corrupt samples."""
    errors = 0
    iterator = iter(it)
    while True:
        try:
            yield next(iterator)
            errors = 0
        except StopIteration:
            return
        except Exception:
            errors += 1
            if errors >= max_consecutive:
                raise


def mix_corpora(sources: Sequence[Iterable], probs: Sequence[float],
                seed: int = 0) -> Iterator:
    """Probabilistic multi-corpus mixer (hf_stream_dataloader.py:66-93)."""
    rng = np.random.default_rng(seed)
    iters = [iter(s) for s in sources]
    alive = list(range(len(iters)))
    p = np.asarray(probs, np.float64)
    while alive:
        pa = p[alive] / p[alive].sum()
        i = alive[rng.choice(len(alive), p=pa)]
        try:
            yield next(iters[i])
        except StopIteration:
            alive.remove(i)


def emilia_stream(
    dataset_name: str = "amphion/Emilia-Dataset",
    split: str = "train",
    epoch_seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    shuffle_buffer: int = 5000,
):
    """HF streaming source sharded per process
    (hf_stream_dataloader.py:304-336).  Requires network access."""
    if hf_datasets is None:
        raise RuntimeError("the `datasets` package is required for HF streaming")
    ds = hf_datasets.load_dataset(dataset_name, split=split, streaming=True)
    ds = ds.shuffle(seed=epoch_seed, buffer_size=shuffle_buffer)
    ds = hf_datasets.distributed.split_dataset_by_node(
        ds, rank=process_index, world_size=process_count
    )
    return skip_errors(ds)


def local_dataset(root: str, cfg: DataConfig, seed: int = 0) -> Iterator[Dict]:
    """Directory walker over wav files (hf_stream_dataloader.py:95-148)."""
    import os

    from streamvoiceanon_tpu_torch.audio.io import read_wav

    paths: List[str] = []
    for dirpath, _, files in os.walk(root):
        paths.extend(
            os.path.join(dirpath, f) for f in files if f.lower().endswith(".wav")
        )
    rng = np.random.default_rng(seed)
    rng.shuffle(paths)
    for p in paths:
        wav, sr = read_wav(p, target_sr=cfg.sample_rate)
        dur = len(wav) / cfg.sample_rate
        if dur < cfg.min_duration or dur > cfg.max_duration:
            continue
        yield {"wave": wav, "path": p}


def synthetic_dataset(cfg: DataConfig, seed: int = 0,
                      frames: tuple = (8, 24), with_text: bool = True
                      ) -> Iterator[Dict]:
    """Random speech-shaped waveforms (+ transcripts) for tests and smoke runs."""
    rng = np.random.default_rng(seed)
    words = ("the a quick brown fox jumps over lazy dog speech voice token "
             "stream frame chunk delay").split()
    while True:
        n = int(rng.integers(*frames)) * 2048
        t = np.arange(n) / cfg.sample_rate
        f0 = rng.uniform(80, 300)
        wav = 0.1 * np.sin(2 * np.pi * f0 * t) * rng.standard_normal(n).clip(-3, 3)
        out = {"wave": wav.astype(np.float32)}
        if with_text:
            k = int(rng.integers(3, 12))
            out["text"] = " ".join(rng.choice(words) for _ in range(k))
            out["language"] = "en-us"
        yield out


def emilia_sample(record: Dict, target_sr: int = 44100) -> Dict:
    """Map one Emilia HF-streaming record to the pipeline sample dict
    (emilia_preprocess, hf_stream_dataloader.py:150-161): decoded audio,
    resampled to the training rate, plus transcript and language tag."""
    import scipy.signal

    audio = record["mp3"] if "mp3" in record else record["audio"]
    wav = np.asarray(audio["array"], np.float32)
    sr = int(audio["sampling_rate"])
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        wav = scipy.signal.resample_poly(wav, target_sr // g, sr // g).astype(
            np.float32
        )
    meta = record.get("json", record)
    return {
        "wave": wav,
        "text": meta.get("text", ""),
        "language": meta.get("language", "en-us"),
    }


def attach_text_ids(source: Iterator[Dict], tokenizer=None) -> Iterator[Dict]:
    """Clean/normalize/tokenize each sample's transcript into `text_ids`
    (PseudoDataset.__iter__ text path, hf_stream_dataloader.py:195-241).
    Samples whose transcript fails the repetition filter are skipped; samples
    without a `text` field pass through unchanged."""
    from streamvoiceanon_tpu_torch.train.text import TextTokenizer, process_text

    if tokenizer is None:
        tokenizer = TextTokenizer()
    for s in source:
        if "text" in s and "text_ids" not in s:
            try:
                ids = process_text(
                    s["text"], s.get("language", "en-us"), tokenizer
                )
            except ValueError:
                continue
            s = dict(s, text_ids=np.asarray(ids, np.int64),
                     eos_id=tokenizer.eos_id)
        yield s


def collate(samples: Sequence[Dict], samples_per_frame: int = 2048) -> Dict:
    """Length-sorted, frame-aligned padded batch
    (hf_stream_dataloader.py:244-302).  When samples carry `text_ids` the
    batch also gets `text` (padded with the tokenizer eos, :258) and
    `text_lens` so the ASR trainer can consume it directly."""
    samples = sorted(samples, key=lambda s: len(s["wave"]), reverse=True)
    lens = [len(s["wave"]) // samples_per_frame * samples_per_frame for s in samples]
    T = max(lens)
    waves = np.zeros((len(samples), T), np.float32)
    for i, s in enumerate(samples):
        waves[i, : lens[i]] = s["wave"][: lens[i]]
    out = {
        "waves": waves,
        "wave_lens": np.asarray(lens, np.int64),
        "frame_lens": np.asarray(lens, np.int64) // samples_per_frame,
    }
    if all("text_ids" in s for s in samples):
        tl = [len(s["text_ids"]) for s in samples]
        L = max(tl)
        eos = int(samples[0].get("eos_id", 50257))
        text = np.full((len(samples), L), eos, np.int64)
        for i, s in enumerate(samples):
            text[i, : tl[i]] = s["text_ids"]
        out["text"] = text
        out["text_lens"] = np.asarray(tl, np.int64)
    return out


def batches(source: Iterator[Dict], cfg: DataConfig,
            samples_per_frame: int = 2048) -> Iterator[Dict]:
    buf: List[Dict] = []
    for s in source:
        buf.append(s)
        if len(buf) == cfg.batch_size:
            yield collate(buf, samples_per_frame)
            buf = []
