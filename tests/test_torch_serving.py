"""The port's `StreamSession` serving surface against the JAX package on the
tiny converter, on the CPU (the kernels' plain versions; JAX interprets
its Pallas kernels where a program set runs them):

* a batch-2 session against JAX's batch-2 session and two port singles;
* `fanout` against a directly built batched session, port and JAX, greedy
  and sampled (the generator's draws are the same (B, ...) rows);
* `with_cache_rows`, `snapshot` -> pickle -> `restore` (greedy and
  sampled), `transfer` from `tpu_optimized` to `per_head_decode` against
  JAX's `transfer`, and sessions made from another owning their state
  (the KV cache and the ring are written in place);
* window mode and `stream_file` against JAX's;
* `process_chunk_async` and `warm_refill_programs`.

Tokens and codes must be exact; waveforms within atol = rtol = 1e-4 and
1e-4 of the largest sample.  JAX's sessions decode greedily: torch's
generators never equal threefry.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.runtime.streaming import StreamSession as JaxSession
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession
from torch_pairs import (GREEDY, JCFG, SAMPLED, SPF, TGREEDY, TOL, chunk, close_wave,
                         pair, per_head, prompt, source)

SCFG = JC.StreamConfig(max_prompt_frames=8, max_seq_frames=28, buffer_frames=4, delay=2)
N = 14  # crosses two refill boundaries at SCFG
WINDOW = JC.StreamConfig(encode_window_frames=16, decode_window_frames=8,
                        max_prompt_frames=8, max_seq_frames=30, buffer_frames=2, delay=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny tensors here: with several test
    workers on the machine, eight threads a worker oversubscribe the cores
    and every small op waits for threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcv, tcv = pair()
    return jcv, tcv, prompt(jcv, seed=0, batch=2)


def _jax(jcv, art, b=slice(0, 1), scfg=SCFG, **kw):
    style, timbre, tokens, codes = (jnp.asarray(a[b]) for a in art)
    return JaxSession(jcv, scfg, key=jax.random.PRNGKey(1), sampling=GREEDY, style=style,
                      timbre=timbre, ref_tokens=tokens, ref_codes=codes,
                      batch=tokens.shape[0], **kw)


def _port(tcv, art, b=slice(0, 1), scfg=SCFG, sampling=TGREEDY, **kw):
    style, timbre, tokens, codes = (a[b] for a in art)
    kw.setdefault("batch", tokens.shape[0])
    return StreamSession(tcv, C.from_fields(scfg), style=style, timbre=timbre,
                         ref_tokens=tokens, ref_codes=codes, sampling=sampling, **kw)


@pytest.fixture(scope="module")
def jax_single(tiny):
    """JAX's one-stream session over N chunks: each chunk's output and
    code ring."""
    jcv, _, art = tiny
    js = _jax(jcv, art)
    src = source(7, N)
    outs, rings = [], []
    for i in range(N):
        outs.append(np.asarray(js.process_chunk(chunk(src, i))))
        rings.append(np.asarray(js.fstate.code_ring))
    assert js.refill_count >= 2
    return src, outs, rings


def test_batch2_session_matches_jax_and_two_singles(tiny):
    jcv, tcv, art = tiny
    js, ts = _jax(jcv, art, slice(0, 2)), _port(tcv, art, slice(0, 2))
    singles = [_port(tcv, art, slice(i, i + 1)) for i in range(2)]
    src = source(3, 10, batch=2)
    for i in range(10):
        x = chunk(src, i)
        a, b = np.asarray(js.process_chunk(x)), ts.process_chunk(x)
        assert b.shape == (2, SPF)
        close_wave(b, a)
        np.testing.assert_array_equal(ts.fstate.code_ring.numpy(),
                                      np.asarray(js.fstate.code_ring))
        for r, s in enumerate(singles):
            close_wave(s.process_chunk(x[r]), b[r])
            np.testing.assert_array_equal(s.fstate.code_ring.numpy()[0],
                                          ts.fstate.code_ring.numpy()[r])
    assert ts.refill_count == js.refill_count >= 1
    assert ts._lm_pos_host == js._lm_pos_host


def test_batched_prompt_rows_must_match_the_batch(tiny):
    _, tcv, art = tiny
    with pytest.raises(ValueError, match="batch=3"):
        _port(tcv, art, slice(0, 2), batch=3)


@pytest.mark.parametrize("sampled", [False, True])
def test_fanout_matches_a_direct_batched_session(tiny, sampled):
    """fanout(2) of a prepared one-stream session continues like a B = 2
    session fed the same history; greedy also as JAX's fanout.  Sampled, the
    prep stops at the delay (no frame drawn yet), so both generators start
    from the seed and draw the same (2, ...) rows."""
    jcv, tcv, art = tiny
    B, delay = 2, SCFG.delay
    warm = source(11, delay + (0 if sampled else 3))
    n_warm = warm.shape[-1] // SPF
    samp = SAMPLED if sampled else TGREEDY
    one = lambda: _port(tcv, art, slice(0, 1), sampling=samp)
    s1 = one()
    for i in range(n_warm):
        s1.process_chunk(chunk(warm, i))
    sf = s1.fanout(B)
    rows = lambda a: np.repeat(a[:1], B, 0)
    sb = _port(tcv, tuple(rows(a) for a in art), slice(0, B), sampling=samp)
    for i in range(n_warm):
        sb.process_chunk(np.repeat(chunk(warm, i)[None], B, 0))
    if not sampled:
        j1 = _jax(jcv, art)
        for i in range(n_warm):
            j1.process_chunk(chunk(warm, i))
        jf = j1.fanout(B)
    src = source(12, 6, batch=B)
    for i in range(6):
        x = chunk(src, i)
        got, want = sf.process_chunk(x), sb.process_chunk(x)
        np.testing.assert_array_equal(sf.fstate.code_ring.numpy(), sb.fstate.code_ring.numpy())
        close_wave(got, want)
        if not sampled:
            close_wave(got, np.asarray(jf.process_chunk(x)))
            np.testing.assert_array_equal(sf.fstate.code_ring.numpy(),
                                          np.asarray(jf.fstate.code_ring))
    assert np.abs(want).max() > 0 and sf.batch == B


def test_with_cache_rows_continues_exactly(tiny, jax_single):
    _, tcv, art = tiny
    src, jouts, _ = jax_single
    full = _port(tcv, art)
    for i in range(4):
        full.process_chunk(chunk(src, i))
    with pytest.raises(ValueError, match="reachable max"):
        full.with_cache_rows(40)
    small = full.with_cache_rows(96)
    assert small.cfg.arvc.decoder.max_seq_len == small.cv.cfg.arvc.decoder.max_seq_len == 96
    assert small.fstate.lm.decode.k_cache.shape[-2] == 96
    assert small.fstate.lm.decode.k_cache.is_contiguous()
    r0 = full.refill_count
    for i in range(4, N):
        a, b = full.process_chunk(chunk(src, i)), small.process_chunk(chunk(src, i))
        np.testing.assert_array_equal(b, a)
        close_wave(b, jouts[i])
    assert small.refill_count == full.refill_count > r0


@pytest.mark.parametrize("sampled", [False, True])
def test_snapshot_pickle_restore_continues_identically(tiny, jax_single, sampled):
    """The snapshot carries the generator's state: a sampled stream goes on
    drawing the same noise after the restore."""
    _, tcv, art = tiny
    src, jouts, jrings = jax_single
    a = _port(tcv, art, sampling=SAMPLED if sampled else TGREEDY, seed=5)
    for i in range(4):
        a.process_chunk(chunk(src, i))
    b = StreamSession.restore(tcv, pickle.loads(pickle.dumps(a.snapshot())))
    for i in range(4, 10):
        x, y = a.process_chunk(chunk(src, i)), b.process_chunk(chunk(src, i))
        np.testing.assert_array_equal(y, x)
        if not sampled:
            close_wave(y, jouts[i])
            np.testing.assert_array_equal(b.fstate.code_ring.numpy(), jrings[i])
    np.testing.assert_array_equal(b.fstate.code_ring.numpy(), a.fstate.code_ring.numpy())
    assert (b.tokens_seen, b._lm_pos_host, b.refill_count) == (
        a.tokens_seen, a._lm_pos_host, a.refill_count)


def test_snapshot_keeps_bf16_state():
    jcv, tcv = pair()
    art = prompt(jcv)
    a = _port(tcv, art, state_dtype=torch.bfloat16)
    src = source(8, 4)
    for i in range(3):
        a.process_chunk(chunk(src, i))
    b = StreamSession.restore(tcv, pickle.loads(pickle.dumps(a.snapshot())))
    assert b.fstate.lm.decode.k_cache.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.process_chunk(chunk(src, 3)), a.process_chunk(chunk(src, 3)))


def test_transfer_tpu_optimized_to_per_head_matches_jax(tiny, jax_single):
    """A session prepared under `tpu_optimized` (flat KV cache and ring,
    packed head) continues under `per_head_decode` (per-head cache) after
    `transfer`.  Its migrated KV cache and ring equal those of JAX's
    `transfer` (a JAX session prepared on its plain path, moved to
    `tpu_optimized` and on to `per_head_decode`: its flat and per-head
    converters both run, and no interpreted kernel), and it goes on as
    JAX's stream (JAX's program sets all give its plain stream, by its own
    tests)."""
    jcv, _, art = tiny
    src, jouts, jrings = jax_single
    ts = _port(pair(JC.tpu_optimized(JCFG))[1], art)
    js = _jax(jcv, art)
    for i in range(5):
        close_wave(ts.process_chunk(chunk(src, i)), jouts[i])
        js.process_chunk(chunk(src, i))
    assert ts.fstate.lm.decode.k_cache.ndim == 4 and ts.fstate.tok.ring.k_ring.ndim == 4
    jcv_b, tcv_b = pair(per_head())
    dev = jax.devices()[0]
    jt = js.transfer(pair(JC.tpu_optimized(JCFG))[0], dev).transfer(jcv_b, dev)
    ts2 = ts.transfer(tcv_b)
    assert ts2.fstate.lm.decode.k_cache.ndim == 5 and ts2.cfg.arvc.decoder.use_pallas_decode
    D = JCFG.arvc.decoder.head_dim
    for got, want in ((ts2.fstate.lm.decode.k_cache, jt.fstate.lm.decode.k_cache[..., :D]),
                      (ts2.fstate.lm.decode.v_cache, jt.fstate.lm.decode.v_cache[..., :D]),
                      (ts2.fstate.tok.ring.k_ring, jt.fstate.tok.ring.k_ring),
                      (ts2.fstate.tok.ring.v_ring, jt.fstate.tok.ring.v_ring)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(5, N):
        close_wave(ts2.process_chunk(chunk(src, i)), jouts[i])
        np.testing.assert_array_equal(ts2.fstate.code_ring.numpy(), jrings[i])
    assert ts2.refill_count >= 2


def _storages(tree) -> set:
    """The storages of every tensor in a nested tree."""
    if torch.is_tensor(tree):
        return {tree.untyped_storage().data_ptr()}
    leaves = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    return set().union(*(_storages(x) for x in leaves))


def test_sessions_made_from_another_own_their_state(tiny):
    """Running the old session after transfer, restore, with_cache_rows and
    fanout (its KV cache and ring written in place) leaves each new one's
    output unchanged: each continues as a session restored from a
    snapshot taken before."""
    _, tcv, art = tiny
    base = _port(tcv, art)
    src, other = source(21, 8), source(22, 4)
    for i in range(4):
        base.process_chunk(chunk(src, i))
    snap = pickle.dumps(base.snapshot())
    made = {"transfer": base.transfer(tcv), "with_cache_rows": base.with_cache_rows(160),
            "restore": StreamSession.restore(tcv, pickle.loads(snap)), "fanout": base.fanout(2)}
    owned = _storages((base.fstate, base._base_lm))
    for name, s in made.items():
        assert not owned & _storages((s.fstate, s._base_lm)), name
    for i in range(4):
        base.process_chunk(chunk(other, i))
    for name, s in made.items():
        ref = StreamSession.restore(tcv, pickle.loads(snap))
        for i in range(4, 8):
            want = ref.process_chunk(chunk(src, i))
            got = s.process_chunk(np.repeat(chunk(src, i)[None], 2, 0) if name == "fanout"
                                  else chunk(src, i))
            for row in (got if name == "fanout" else [got]):
                close_wave(row, want)


def test_window_mode_matches_jax(tiny):
    """incremental=False: the rolling encode window, the decoded frames and
    the vocoder window, across a prompt refill, as JAX's."""
    jcv, tcv, art = tiny
    scfg = WINDOW
    js = _jax(jcv, art, scfg=scfg, incremental=False)
    ts = _port(tcv, art, scfg=scfg, incremental=False)
    src = source(31, 14)
    for i in range(14):
        a, b = np.asarray(js.process_chunk(chunk(src, i))), ts.process_chunk(chunk(src, i))
        assert b.shape == (SPF,)
        close_wave(b, a)
        np.testing.assert_array_equal(ts.code_window.numpy(), np.asarray(js.code_window))
        np.testing.assert_array_equal(ts.tok_ring.numpy(), np.asarray(js.tok_ring))
    assert ts.refill_count == js.refill_count >= 1
    assert ts.state.decode.pos == int(js.state.decode.pos)
    with pytest.raises(ValueError, match="incremental"):
        ts.process_chunk_async(chunk(src, 0))


@pytest.mark.parametrize("incremental", [True, False])
def test_stream_file_matches_jax(tiny, incremental):
    jcv, tcv, art = tiny
    scfg = SCFG if incremental else WINDOW
    wav = source(41, 9)[: 9 * SPF - 700]  # not a whole number of chunks: left-padded
    a = np.asarray(_jax(jcv, art, scfg=scfg, incremental=incremental).stream_file(wav))
    b = _port(tcv, art, scfg=scfg, incremental=incremental).stream_file(wav)
    assert b.shape == (9 * SPF,)
    close_wave(b, a)


@pytest.mark.parametrize("batch", [1, 2])
def test_process_chunk_async_equals_process_chunk(tiny, batch):
    _, tcv, art = tiny
    a, b = _port(tcv, art, slice(0, batch)), _port(tcv, art, slice(0, batch))
    src = source(51, 8, batch=batch) if batch > 1 else source(51, 8)
    for i in range(8):
        out = a.process_chunk_async(chunk(src, i))
        assert torch.is_tensor(out) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), b.process_chunk(chunk(src, i)))


def test_warm_refill_programs_leaves_the_stream_unchanged(tiny, jax_single):
    _, tcv, art = tiny
    src, jouts, _ = jax_single
    s = _port(tcv, art)
    for i in range(5):
        s.process_chunk(chunk(src, i))
    s.warm_refill_programs()
    for i in range(5, N):
        close_wave(s.process_chunk(chunk(src, i)), jouts[i])
    assert s.refill_count >= 2
