"""The port's last modules against the JAX package's, on the CPU at the tiny
size:

* `utils/profiling.py`: `StageTimers` as tests/test_profiling.py tests it,
  and `trace` writing a Chrome trace;
* `utils/roofline.py`: `stage_table` on the tiny converter's trees under
  three program sets, FLOPs and weight bytes equal to JAX's on the same
  trees (the converter's packed copies not counted), the state bytes of
  the port's tensors as allocated against JAX's (equal where the layouts
  are), the fast loop's reads with and without its kernel, the KV-state
  traffic and `device_peaks` (the counterparts of
  tests/test_bench_plumbing.py's roofline tests);
* `ops/sampling.py` and `ops/quantizers.py`: the repetition penalty,
  `window_covers_nucleus`, `lfq_indices_to_codes` and the BSQ entropy
  loss, exactly or within 1e-6; `DualARConfig.max_delay` and
  `dual_ar.embed_tokens`;
* `parallel/mesh.py`: the spec tree equal to JAX's, the head-aligned
  wqkv shards against the heads' columns, the one-process mesh and the
  backend's choice;
* in four gloo processes on a 2 x 2 mesh (tests/torch_mesh.py, one world
  for every scenario): `forward_train`'s losses and gathered gradients
  against JAX's (rtol 1e-4, atol 2e-5), one MuonAdamW update of
  model-sharded leaves against JAX's unsharded one (the tolerances of
  tests/test_multichip.py), `lfq_soft_entropy_loss(group=...)` against
  JAX's shard_map (rtol 1e-5), one `ARVCTrainer(n_model_shards=2)` step
  against JAX's trainer on the virtual mesh, `global_batch_from_local`
  giving a model group one set of rows, and a greedy float32
  `BatchServer(n_model=2)` against JAX's `BatchServer` on a 2 x 2 mesh and
  against the port's one-process server: codes equal, wav within 1e-4.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import arvc as jarvc
from streamvoiceanon_tpu.models import dual_ar as jdual
from streamvoiceanon_tpu.models import tokenizer_stream as jtok_stream
from streamvoiceanon_tpu.models import vocoder as jvocoder
from streamvoiceanon_tpu.ops import quantizers as jq
from streamvoiceanon_tpu.ops import sampling as jsampling
from streamvoiceanon_tpu.parallel import mesh as jmesh
from streamvoiceanon_tpu.parallel.serving import BatchServer as JaxServer
from streamvoiceanon_tpu.train import muon as jmuon
from streamvoiceanon_tpu.train.arvc_trainer import ARVCTrainer as JaxTrainer
from streamvoiceanon_tpu.train.arvc_trainer import TrainerConfig as JaxTrainerConfig
from streamvoiceanon_tpu.utils import roofline as jroof
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import dual_ar, tokenizer_stream, vocoder
from streamvoiceanon_tpu_torch.ops import quantizers as q
from streamvoiceanon_tpu_torch.ops import sampling
from streamvoiceanon_tpu_torch.parallel import mesh as M
from streamvoiceanon_tpu_torch.parallel.serving import BatchServer
from streamvoiceanon_tpu_torch.utils import roofline as roof
from streamvoiceanon_tpu_torch.utils.profiling import StageTimers, trace
from torch_mesh import run_ranks
from torch_pairs import JCFG, TGREEDY, close_wave, pair, per_head, prompt, source, trees

JCFG2 = JC.replace(JCFG, arvc=JC.replace(JCFG.arvc, decoder=JC.replace(
    JCFG.arvc.decoder, n_layer=2, n_fast_layer=2)))
TCFG2 = C.from_fields(JCFG2)
B, T = 4, 7
X_LENS = np.array([7, 5, 3, 6])
DELAY = 2
TRAIN = dict(lr=3e-3, gamma=0.9, min_lr=1e-5, clip=1000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_stage_timers_accumulate_and_report():
    t = StageTimers()
    for _ in range(5):
        with t.stage("host"):
            pass
        out = t.timed("matmul", lambda x: x @ x, torch.ones((32, 32)))
    assert torch.equal(out, torch.full((32, 32), 32.0))
    s = t.summary()
    assert s["matmul"]["n"] == 5 and s["host"]["n"] == 5
    assert set(s["matmul"]) == {"n", "p50_ms", "p95_ms", "mean_ms", "total_s"}
    assert s["matmul"]["p50_ms"] >= 0
    rep = t.report()
    assert "matmul" in rep and "p95" in rep


def test_trace_noop_and_real(tmp_path):
    with trace(None):
        pass
    with trace(""):
        pass
    assert not any(tmp_path.iterdir())
    with trace(str(tmp_path / "prof")):
        (torch.arange(128.0) * 2).sum()
    path = tmp_path / "prof" / "trace.json"
    assert path.stat().st_size > 0
    assert json.loads(path.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def _converter(jcfg):
    t = trees()
    return P.converter_from_numpy(C.from_fields(jcfg), t["tokenizer_params"],
                                  t["vocoder_params"], t["arvc_params"], device="cpu")


@pytest.mark.parametrize("flags", ["plain", "tpu_optimized", "per_head"])
def test_stage_table_matches_jax(flags):
    """FLOPs and weight bytes equal JAX's on the same trees, the packed
    copies (`enc_packed`, `enc_units`, `head_packed`) and `float32_trees`
    not counted; the state bytes are the port's tensors as allocated."""
    jcfg = {"plain": JCFG, "tpu_optimized": JC.tpu_optimized(JCFG),
            "per_head": per_head(JCFG)}[flags]
    t, cv = trees(), _converter(jcfg)
    tcfg = cv.cfg
    cv.float32_trees  # noqa: B018  (built, not counted)
    want = jroof.stage_table(jcfg, t["tokenizer_params"], t["arvc_params"],
                             t["vocoder_params"])
    got = roof.stage_table(tcfg, cv.tokenizer_params, cv.arvc_params, cv.vocoder_params)
    assert got == want
    if flags == "tpu_optimized":
        assert "head_packed" in cv.vocoder_params
    # states: the port's as allocated
    jtok = jtok_stream.init_stream_state(jax.tree.map(jnp.asarray, t["tokenizer_params"]),
                                         jcfg.tokenizer, 1)
    ptok = tokenizer_stream.init_stream_state(cv.tokenizer_params, tcfg.tokenizer, 1,
                                              device="cpu")
    # the ring's token count is a host integer in the port, an int32 in JAX
    assert roof.tree_bytes(ptok) == jroof.tree_bytes(jtok) - 4
    jv = jvocoder.init_stream_state(jax.tree.map(jnp.asarray, t["vocoder_params"]),
                                    jcfg.vocoder, 1)
    pv = vocoder.init_stream_state(cv.vocoder_params, tcfg.vocoder, 1, device="cpu")
    assert roof.tree_bytes(pv) == jroof.tree_bytes(jv)
    d = tcfg.arvc.decoder
    js = jdual.init_state(jcfg.arvc.decoder, cache_dtype=jnp.bfloat16)
    ps = dual_ar.init_state(d, cache_dtype=torch.bfloat16)
    kv = roof.slow_stage(tcfg, cv.arvc_params, ps)["state_bytes"]
    assert kv == 2 * d.n_layer * d.n_local_heads * d.max_seq_len * d.head_dim * 2
    # JAX pads the per-head cache's head dim to 128 lanes; the port does not
    jkv = jroof.slow_stage(jcfg, t["arvc_params"], js)["state_bytes"]
    assert kv == (jkv * d.head_dim // 128 if flags == "per_head" else jkv)


def test_chunk_roofline_bytes_exact_and_peaks():
    cv = _converter(JC.tpu_optimized(JCFG))
    peaks = roof.device_peaks("NVIDIA H100 80GB HBM3")
    rf = roof.chunk_roofline(cv.cfg, cv.tokenizer_params, cv.arvc_params, cv.vocoder_params,
                             compute_s=1e-3, peaks=peaks)
    assert set(rf["stages"]) == {"encode", "lm_slow", "lm_fast", "vocode"}
    for s in rf["stages"].values():
        assert s["flops"] > 0 and s["hbm_bytes"] > 0
    m = cv.arvc_params["model"]
    want = roof.tree_bytes({k: m[k] for k in ("layers", "norm", "output")})
    assert rf["stages"]["lm_slow"]["hbm_bytes"] == want
    assert rf["bound"] == "hbm-bandwidth"
    assert rf["pct_peak_bw"] > 0 and rf["mfu_pct"] >= 0 and rf["bw_floor_ms"] > 0
    assert rf["bw_floor_ms"] == round(rf["chunk_hbm_bytes"] / 3.35e12 * 1e3, 3)
    assert set(rf["stage_bw_floor_ms"]) == set(rf["stages"])
    text = roof.format_report(rf)
    assert "bandwidth floor" in text and "lm_fast" in text


def test_fast_loop_reads_with_and_without_its_kernel():
    cv = _converter(JCFG)
    base = roof.fast_stage(cv.cfg, cv.arvc_params)["weight_bytes"]
    on = C.replace(cv.cfg, arvc=C.replace(cv.cfg.arvc, decoder=C.replace(
        cv.cfg.arvc.decoder, use_pallas_fast_decode=True)))
    assert base == cv.cfg.arvc.decoder.num_codebooks * roof.fast_stage(
        on, cv.arvc_params)["weight_bytes"]


def test_state_traffic_counts_the_kv_cache():
    cv = _converter(JC.tpu_optimized(JCFG))
    st = dual_ar.init_state(cv.cfg.arvc.decoder, cache_dtype=torch.bfloat16)
    got = roof.slow_stage(cv.cfg, cv.arvc_params, st)
    assert got["state_bytes"] == roof.tree_bytes(st.k_cache) + roof.tree_bytes(st.v_cache)
    assert roof.tree_bytes((st, 3, None)) == got["state_bytes"] + 4  # trunc, int32


def test_device_peaks_table():
    h100 = roof.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"device_kind": "NVIDIA H100 80GB HBM3", "bf16_flops": 989e12,
                    "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12}
    assert roof.device_peaks("weird accelerator") is None
    assert roof.device_peaks("cpu") is None
    assert roof.device_peaks(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the functions missing until now
# ---------------------------------------------------------------------------


def test_repetition_penalty_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(50).astype(np.float32)
    prev = np.array([3, 7, 7, 20, 41], np.int32)
    want = jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(prev), 1.3)
    got = sampling.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(prev),
                                            1.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kw in (dict(greedy=True), dict(top_k_window=0), dict(top_k_window=8)):
        key = jax.random.PRNGKey(5)
        jtok = jsampling.sample_token(key, jnp.asarray(logits), temperature=0.9, top_p=0.9,
                                      repetition_penalty=1.3, previous_tokens=jnp.asarray(prev),
                                      **kw)
        width = kw.get("top_k_window") or 50
        g = np.asarray(jax.random.gumbel(key, (width,), jnp.float32))[None]
        ttok = sampling.sample_token(torch.from_numpy(logits)[None], torch.from_numpy(g),
                                     temperature=0.9, top_p=0.9, repetition_penalty=1.3,
                                     previous_tokens=torch.from_numpy(prev)[None], **kw)
        assert int(ttok[0]) == int(jtok), kw


def test_window_covers_nucleus_matches_jax():
    rng = np.random.default_rng(1)
    for scale in (0.1, 1.0, 8.0):
        logits = (rng.standard_normal((6, 100)) * scale).astype(np.float32)
        for k, p in ((8, 0.7), (32, 0.9), (100, 0.99)):
            want = np.asarray(jax.vmap(lambda x: jsampling.window_covers_nucleus(x, k, p))(
                jnp.asarray(logits)))
            got = sampling.window_covers_nucleus(torch.from_numpy(logits), k, p).numpy()
            np.testing.assert_array_equal(got, want)


def test_lfq_indices_to_codes_and_entropy_match_jax():
    rng = np.random.default_rng(2)
    bits, dim = 13, 32
    params = {"project_out": {"w": rng.standard_normal((bits, dim)).astype(np.float32),
                              "b": rng.standard_normal(dim).astype(np.float32)}}
    idx = rng.integers(0, 2 ** bits, (3, 5)).astype(np.int32)
    want = jq.lfq_indices_to_codes(jax.tree.map(jnp.asarray, params), jnp.asarray(idx), bits)
    got = q.lfq_indices_to_codes(jax.tree.map(torch.from_numpy, params), torch.from_numpy(idx),
                                 bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    h = rng.standard_normal((40, bits)).astype(np.float32)
    for tau, gamma in ((1.0, 1.0), (0.5, 0.0), (2.0, 0.3)):
        want = float(jq.lfq_soft_entropy_loss(jnp.asarray(h), tau, gamma))
        got = float(q.lfq_soft_entropy_loss(torch.from_numpy(h), tau, gamma))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_max_delay_and_embed_tokens_match_jax():
    for delay in ((0, 1, 2, 3, 4, 5, 6, 7, 8), (2,), 3):
        jd = JC.DualARConfig(delay=delay)
        assert C.DualARConfig(delay=delay).max_delay == jd.max_delay
    t = trees()["arvc_params"]["model"]
    tok = np.array([[0, 5, 8191], [3, 3, 1]], np.int32)
    want = jdual.embed_tokens(jax.tree.map(jnp.asarray, t), jnp.asarray(tok))
    got = dual_ar.embed_tokens(P.arvc_params(trees()["arvc_params"], "cpu")["model"],
                               torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the mesh's rules in one process
# ---------------------------------------------------------------------------


def _as_tuples(tree):
    if isinstance(tree, JP):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return [_as_tuples(v) for v in tree]


def test_spec_tree_matches_jax():
    model = trees()["arvc_params"]["model"]
    want = _as_tuples(jmesh.dual_ar_param_specs(jax.tree.map(jnp.asarray, model)))
    assert M.dual_ar_param_specs(model) == want
    specs = M.dual_ar_param_specs(trees()["arvc_params"])
    assert specs["model"] == want and specs["context_in"] == {"w": (), "b": ()}
    assert M.leaf_shards(specs) == {("model", s, n, "w"): 2 if n in ("wqkv", "w1", "w3")
                                    else 1 for s in ("layers", "fast_layers")
                                    for n in ("wqkv", "w1", "w3", "wo", "w2")}


def test_wqkv_shards_are_whole_heads_and_gather_back():
    """Rank r's wqkv columns are those of its heads in q, k and v; the
    shards in rank order, put back at those columns, are the leaf."""
    d = C.replace(TCFG2.arvc.decoder, n_head=4, n_local_heads=2)
    rng = np.random.default_rng(4)
    H, nl, hd = d.n_head, d.n_local_heads, d.head_dim
    w = torch.from_numpy(rng.standard_normal((2, d.dim, (H + 2 * nl) * hd)).astype(np.float32))
    stack = {"wqkv": {"w": w}}
    specs = {"layers": M.dual_ar_param_specs({"layers": stack})["layers"]}
    pieces, cols = [], []
    for r in range(2):
        mesh = M.Mesh(1, 2, r, torch.device("cpu"))
        out = M.shard_params({"layers": stack}, mesh, specs, d)["layers"]
        assert isinstance(out, M.ShardedStack) and out.n_model == 2
        heads = lambda first, n, off: [off + h * hd + i for h in range(first, first + n)
                                       for i in range(hd)]
        want = (heads(r * H // 2, H // 2, 0) + heads(r * nl // 2, nl // 2, H * hd)
                + heads(r * nl // 2, nl // 2, (H + nl) * hd))
        torch.testing.assert_close(out["wqkv"]["w"], w[..., want], rtol=0, atol=0)
        pieces.append(out["wqkv"]["w"])
        cols += want
    whole = torch.empty_like(w)
    whole[..., cols] = torch.cat(pieces, dim=-1)
    assert torch.equal(whole, w)
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_params({"layers": stack}, M.Mesh(1, 3, 0, torch.device("cpu")), specs, d)
    with pytest.raises(ValueError, match="needs its config"):
        M.shard_params({"layers": stack}, M.Mesh(1, 2, 0, torch.device("cpu")), specs)


def test_one_process_mesh_and_backend_choice():
    mesh = M.make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="initialized process group"):
        M.make_mesh(n_model=2, device="cpu")
    assert M.choose_backend(torch.device("cpu")) == "gloo"
    assert M.choose_backend(torch.device("cuda"), ranks_per_card=2) == "gloo"
    assert M.choose_backend(torch.device("cuda"), ranks_per_card=1) == "nccl"
    batch = {"x": np.arange(8).reshape(4, 2)}
    assert M.shard_batch(batch, mesh)["x"].tolist() == batch["x"].tolist()
    with pytest.raises(ValueError, match="over 3 data ranks"):
        M.shard_batch(batch, M.Mesh(3, 1, 0, torch.device("cpu")))
    assert M.shard_batch(batch, M.Mesh(2, 2, 3, torch.device("cpu")))["x"].tolist() == [
        [4, 5], [6, 7]]


# ---------------------------------------------------------------------------
# four gloo processes, one 2 x 2 mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def batch_np():
    d = TCFG2.arvc.decoder
    rng = np.random.default_rng(0)
    return {"content": rng.integers(0, d.vocab_size, (B, T)).astype(np.int32),
            "base_target": rng.integers(0, d.vocab_size, (B, T)).astype(np.int32),
            "target": rng.integers(0, d.codebook_size, (B, d.num_codebooks, T)).astype(np.int32),
            "x_lens": X_LENS.astype(np.int32),
            "style": rng.standard_normal((B, 192)).astype(np.float32),
            "timbre": rng.standard_normal((B, 32, 128)).astype(np.float32)}


@functools.lru_cache(maxsize=1)
def arvc_np():
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    return rp.arvc_params_np(TCFG2.arvc, 3)


@functools.lru_cache(maxsize=1)
def model_grads_np():
    rng = np.random.default_rng(7)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
                        arvc_np()["model"])


@functools.lru_cache(maxsize=1)
def lfq_h():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((64, 8)).astype(np.float32)
    h += np.repeat(np.linspace(-2, 2, 4), 16)[:, None].astype(np.float32)
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=1)
def serve_args():
    jcv, _ = pair()
    style, timbre, tokens, codes = prompt(jcv, seed=0, batch=4)
    return jcv, (source(61, 6, batch=4), tokens, codes, style, timbre)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    t = trees()
    trees_np = {k: t[k] for k in ("tokenizer_params", "vocoder_params", "arvc_params")}
    inputs = {
        "forward_train": {"cfg": TCFG2, "arvc_np": arvc_np(), "batch": batch_np(),
                          "delay": DELAY},
        "muon_update": {"cfg": TCFG2, "model_np": arvc_np()["model"],
                        "grads_np": model_grads_np(), "lr": 1e-3, "clip": 1000.0},
        "lfq_entropy": {"h": lfq_h()},
        "local_batch": {"shape": (2, 3)},
        "trainer_step": {"cfg": TCFG2, "trees": dict(trees_np, arvc_params=arvc_np()),
                         "batch": batch_np(), "delays": [DELAY], "tcfg": TRAIN,
                         "log_dir": str(tmp / "run")},
        "batch_server": {"trees": trees_np, "sampling": TGREEDY,
                         "cfgs": {"plain": C.from_fields(JCFG),
                                  "per_head": C.from_fields(per_head(JCFG))},
                         "batches": (4, 3), "args": serve_args()[1]},
    }
    return run_ranks(list(inputs), 4, inputs, tmp)


def _close_tree(got, want, rtol, atol_scale, what):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_scale, err_msg=f"{what} {path}")


def test_forward_train_over_the_mesh_matches_jax(mesh_runs):
    jp = jax.tree.map(jnp.asarray, arvc_np())
    b = {k: jnp.asarray(v) for k, v in batch_np().items()}

    def loss(p):
        cb, tok = jarvc.forward_train(p, JCFG2.arvc, b["content"], b["base_target"],
                                      b["target"], b["x_lens"], b["style"], b["timbre"], DELAY)
        return cb + tok, (cb, tok)

    (_, (cb, tok)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    for r, res in enumerate(mesh_runs):
        out = res["forward_train"]
        np.testing.assert_allclose(out["losses"], [float(cb), float(tok)], rtol=1e-4)
        _close_tree(out["grads"], jg, 1e-4, 2e-5, f"rank {r} gradient")
        d = TCFG2.arvc.decoder
        assert out["local_wqkv"] == (d.n_layer, d.dim, (d.n_head + 2 * d.n_local_heads)
                                     * d.head_dim // 2)


def test_muon_update_of_sharded_leaves_matches_jax(mesh_runs):
    jp = jax.tree.map(jnp.asarray, arvc_np()["model"])
    jg = jax.tree.map(jnp.asarray, model_grads_np())
    opt = optax.chain(optax.clip_by_global_norm(1000.0), jmuon.muon_adamw(lr=1e-3),
                      optax.scale_by_schedule(jmuon.exp_decay_schedule(1e-3)))

    @jax.jit
    def one_step(p, g):
        upd, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, upd)

    want = one_step(jp, jg)
    for res in mesh_runs:
        out = res["muon_update"]
        _close_tree(out["params"], want, 1e-4, 2e-5, "updated")
        np.testing.assert_allclose(out["norm"], float(optax.global_norm(jg)), rtol=1e-6)


def test_lfq_entropy_over_a_group_matches_jax_shard_map(mesh_runs):
    from functools import partial

    h = jnp.asarray(lfq_h())
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    sharded = jax.device_put(h, NamedSharding(mesh, JP("data")))

    @partial(shard_map, mesh=mesh, in_specs=JP("data"), out_specs=JP())
    def dist_loss(x):
        return jax.lax.pmean(jq.lfq_soft_entropy_loss(x, axis_name="data"), "data")[None]

    want = float(dist_loss(sharded)[0])
    for res in mesh_runs:
        out = res["lfq_entropy"]
        np.testing.assert_allclose(out["loss"], want, rtol=1e-5)
        assert abs(out["local"] - want) > 1e-4  # without the group the term differs


def test_local_batches_agree_within_a_model_group(mesh_runs):
    """Each rank's process-local rows become its model group's first
    rank's: ranks 0 and 1 (data index 0) hold rank 0's, ranks 2 and 3 rank
    2's."""
    for r, res in enumerate(mesh_runs):
        out = res["local_batch"]
        assert out["data_index"] == r // 2
        np.testing.assert_array_equal(out["x"], np.full((2, 3), 2 * (r // 2)))


def test_sharded_trainer_step_matches_jax_trainer(mesh_runs, tmp_path):
    t = trees()
    jt = JaxTrainer(JCFG2, JaxTrainerConfig(log_dir=str(tmp_path), n_model_shards=2,
                                            **TRAIN),
                    *(jax.tree.map(jnp.asarray, x) for x in (
                        arvc_np(), t["tokenizer_params"], t["vocoder_params"])))
    feats = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch_np().items()}, jt.mesh)
    with jt.mesh:
        jt.state, aux = jt._step(jt.state, feats, DELAY)
    for r, res in enumerate(mesh_runs):
        out = res["trainer_step"]
        assert out["mesh"] == (2, 2, r) and out["local_w1"][-1] * 2 == TCFG2.arvc.decoder.intermediate_size
        got = out["aux"][0]
        for k in ("loss", "codebook_loss", "token_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], float(aux[k]), rtol=1e-5, err_msg=k)
    # the checkpoint, written by rank 0, is the whole tree in the one-card format
    saved = torch.load(f"{mesh_runs[0]['trainer_step']['ckpt']}/arvc.pt", weights_only=True)
    want = jax.tree.map(np.asarray, jt.state.params)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = saved
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=str(path))


def test_sharded_batch_server_matches_jax_and_one_process(mesh_runs):
    jcv, args = serve_args()
    jserver = JaxServer(jcv, mesh=jmesh.make_mesh(n_data=2, n_model=2,
                                                  devices=jax.devices()[:4]))
    want = jserver.convert(*args, sampling=JC.SamplingConfig(greedy=True), delay=2)
    _, tcv = pair()
    one = BatchServer(tcv)
    _, tcv_ph = pair(per_head(JCFG))
    one_ph = BatchServer(tcv_ph)
    from streamvoiceanon_tpu_torch.models import arvc

    for Bs in (4, 3):  # split over 'data', then replicated
        sub = [x[:Bs] for x in args]
        recorded, orig = [], arvc.generate
        arvc.generate = lambda *a, **kw: recorded.append(orig(*a, **kw)) or recorded[-1]
        try:
            ref = one.convert(*sub, sampling=TGREEDY, delay=2)
            ref_ph = one_ph.convert(*sub, sampling=TGREEDY, delay=2)
        finally:
            arvc.generate = orig
        for res in mesh_runs:
            plain, ph = res["batch_server"]["plain", Bs], res["batch_server"]["per_head", Bs]
            assert plain["wav"].shape == (Bs, 6 * 2048)
            if Bs == 4:
                close_wave(plain["wav"], want)
            np.testing.assert_array_equal(plain["codes"], recorded[0].numpy())
            np.testing.assert_array_equal(ph["codes"], recorded[1].numpy())
            np.testing.assert_allclose(plain["wav"], ref, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(ph["wav"], ref_ph, atol=1e-4, rtol=1e-4)
