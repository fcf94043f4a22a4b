"""The port's spans (`utils/profiling.py`) on the CPU at the
tiny geometry of tests/torch_pairs.py:

* off by default: `infer` and a trainer step record nothing, open no
  profiler range and create no CUDA event;
* on: `infer` is one `infer` span over `prompt`, `encode`, `generate`,
  `vocode` and `to_host`, one request id for all, `generate` over
  `prefill` and Ts - 1 `frame` spans; a trainer step is one `train_step`
  span over `features`, `fwd_bwd`, `optim` and `sync`; device ms are None
  in a process that has not used the card, else read from the span's pair
  of CUDA events after one synchronize;
* the spans are `sva.<name>` ranges in a `torch.profiler` run's timeline;
* `trace(dir)` writes `spans.json` beside `trace.json`.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
from streamvoiceanon_tpu_torch.train import data
from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig
from streamvoiceanon_tpu_torch.ops import kernel_wrappers
from streamvoiceanon_tpu_torch.utils import profiling
from streamvoiceanon_tpu_torch.utils.profiling import span, trace, tracing
from torch_pairs import JCFG, SPF, source, trees

TCFG = C.from_fields(JCFG)
SRC_FRAMES = 5  # padded to 16 frames for the LM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converter():
    t = trees()
    return VoiceConverter(P.converter_from_numpy(
        TCFG, t["tokenizer_params"], t["vocoder_params"], t["arvc_params"], device="cpu",
        campplus_np=t["campplus_params"], speaker_np=t["speaker_params"]))


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    t = trees()
    return ARVCTrainer(TCFG, TrainerConfig(log_dir=str(tmp_path_factory.mktemp("train"))),
                       P.arvc_params(t["arvc_params"], "cpu"),
                       P.tokenizer_params(t["tokenizer_params"], "cpu"),
                       P.vocoder_params(t["vocoder_params"], "cpu"),
                       P.campplus_params(t["campplus_params"], "cpu"),
                       P.speaker_params(t["speaker_params"], "cpu"), device="cpu")


def _infer(converter, trainer):
    out = converter.infer(source(1, SRC_FRAMES), [source(2, 6)], delay=2,
                          sampling=C.SamplingConfig(greedy=True))
    assert out.shape == (SRC_FRAMES * SPF,)


def _train_step(converter, trainer):
    src = data.synthetic_dataset(data.DataConfig(), seed=4, frames=(4, 7), with_text=False)
    aux = trainer.train_step(data.collate([next(src) for _ in range(2)]))
    assert np.isfinite(aux["loss"])


CALLS = {"infer": _infer, "train_step": _train_step}
STAGES = {"infer": ["prompt", "encode", "generate", "vocode", "to_host"],
          "train_step": ["features", "fwd_bwd", "optim", "sync"]}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_off_records_nothing(call, converter, trainer, monkeypatch):
    """With the recorder off a span is the shared null context: no span
    object, no profiler range, no CUDA event."""

    def refuse(*a, **k):
        raise AssertionError("created while the recorder is off")

    monkeypatch.setattr(profiling._Span, "__init__", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling._recorder is None
    assert span("anything") is span("other") is profiling._NULL
    CALLS[call](converter, trainer)
    assert profiling._recorder is None


@pytest.mark.parametrize("call", sorted(CALLS))
def test_on_records_each_stage(call, converter, trainer, monkeypatch):
    """The span tree of one call.  The calls run on the CPU, so the
    process is held to one that has not used the card (as on a host
    without one): no span takes CUDA events."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with tracing() as rec:
        CALLS[call](converter, trainer)
    out = rec.export()
    spans = out["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == [call]
    root = roots[0]
    assert root["request"] == root["id"]
    assert {s["request"] for s in spans} == {root["id"]}
    assert [s["name"] for s in spans if s["parent"] == root["id"]] == STAGES[call]
    assert all(s["device_ms"] is None for s in spans)  # no card: host clock only
    assert all(s["host_ms"] >= 0 for s in spans)
    assert root["host_ms"] >= sum(s["host_ms"] for s in spans if s["parent"] == root["id"])
    assert out["launches"] == dict.fromkeys(  # the CPU launches no kernel
        [w.__name__ for w in kernel_wrappers().values()], 0)
    if call == "infer":
        gen = [s for s in spans if s["name"] == "generate"][0]
        under = [s["name"] for s in spans if s["parent"] == gen["id"]]
        frames = -(-SRC_FRAMES // 16) * 16
        assert under == ["prefill"] + ["frame"] * (frames - 1)
    summary = rec.summary()
    assert set(summary[call]) == {"host"}
    assert set(summary[call]["host"]) == {"n", "p50_ms", "p95_ms", "mean_ms", "total_s"}


def test_spans_in_the_profilers_timeline(converter):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing():
            _infer(converter, None)
    names = {e.name for e in prof.events()}
    want = {profiling.PREFIX + n for n in ["infer", "prefill", "frame"] + STAGES["infer"]}
    assert want <= names


def test_trace_writes_spans_json(tmp_path):
    with trace(str(tmp_path / "prof")):
        with span("outer"):
            with span("inner"):
                (torch.arange(64.0) * 2).sum()
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [s["name"] for s in got["spans"]] == ["outer", "inner"]
    assert got["spans"][1]["parent"] == got["spans"][0]["id"]
    assert len(got["launches"]) == 6
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert profiling._recorder is None


def test_recorder_requests_threads_and_misuse():
    """Each outermost span starts a request; another thread keeps its own
    parents; the recorder refuses to nest or to export while on."""
    with tracing() as rec:
        with span("a"):
            pass
        with span("b"):
            t = threading.Thread(target=lambda: span("c").__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with pytest.raises(RuntimeError, match="already on"):
            with tracing():
                pass
        with pytest.raises(RuntimeError, match="while the recorder is on"):
            rec.export()
    s = {x["name"]: x for x in rec.export()["spans"]}
    assert s["a"]["request"] != s["b"]["request"]
    assert s["c"]["parent"] is None and s["c"]["request"] == s["c"]["id"]


def test_device_ms_from_the_event_pair(monkeypatch):
    """Once the process has used the card, a span records a start and an
    end event on the current stream; `export` synchronizes once, reads
    each pair's elapsed time and returns the events to the pool."""

    class Event:
        def __init__(self):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: Event())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    monkeypatch.setattr(profiling, "_EVENTS", [])
    with tracing() as rec:
        with span("outer"):
            with span("inner"):
                time.sleep(0.002)
    assert syncs == []  # nothing waits while the stretch runs
    out = {s["name"]: s for s in rec.export()["spans"]}
    assert len(syncs) == 1
    assert out["outer"]["device_ms"] >= out["inner"]["device_ms"] >= 2.0
    assert len(profiling._EVENTS) == 4
    assert rec.summary()["inner"]["device"]["n"] == 1
