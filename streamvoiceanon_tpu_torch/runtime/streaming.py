"""Streaming voice conversion: `StreamSession`, as the JAX package's
runtime/streaming.py.

Two modes:

* incremental (default): each chunk of decode_chunk_frames * 2048 samples
  runs three stages on state carried across chunks:
  1. incremental content encode (`tokenizer_stream.encode_stream`);
  2. the LM frame decode (`arvc.decode_one` -> `dual_ar.decode_frame`: the
     slow-step kernel, or the layer loop (on the per-head decode-attention
     kernel or plain) and the windowed sampler; then the fast loop, on its
     kernel or plain, as the decoder's flags and the batch say), then the
     incremental vocoder (`vocoder.decode_stream`);
  3. host logic: silence while the first `delay` tokens accumulate, a
     one-time delay prefill, and the periodic prompt refill when the LM
     position reaches `max_seq_frames` — the fast refill appends the
     recent history to a stashed post-prompt state, and the background
     refill builds that state one chunk at a time over the window before
     the boundary, so the boundary chunk only swaps it in.
* window (`incremental=False`, batch 1): the reference's state machine — a
  rolling encode window re-encoded by the offline tokenizer every chunk,
  and a vocoder window of codes seeded with the reference codes' tail,
  decoded by the offline vocoder.

A session serves `batch` streams at once (every stream its own prompt
rows); `fanout` clones a prepared one-stream session into B streams.
The prompt comes from reference audio (`runtime/pipeline.py`) or
precomputed.  The position trajectory is deterministic, so refills are
scheduled from host counters with no device read-back.  Sampling noise is
drawn on the device from the session's `torch.Generator`.

The KV caches and the tokenizer's flat ring are written in place by the
frame decode and the ring step, so every session made from another
(`transfer`, `restore`, `with_cache_rows`, `fanout`) gets state tensors
and a generator of its own.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import SamplingConfig, StreamConfig
from streamvoiceanon_tpu_torch.models import arvc, dual_ar, tokenizer, tokenizer_stream, vocoder
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.params import Converter
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter


class FusedState(NamedTuple):
    tok: tokenizer_stream.TokenizerStreamState
    lm: arvc.ARVCState
    voc: Dict
    tok_ring: torch.Tensor  # (B, R) recent content tokens (refill history)
    code_ring: torch.Tensor  # (B, nq, R) recent decoded codes (refill history)


def _tree_map(fn, x, *rest):
    """fn over the tensor leaves of nested NamedTuples, tuples, lists and
    dicts (other leaves, ints and None, kept from `x`); `rest` are trees of
    the same structure whose leaves are passed beside x's."""
    if torch.is_tensor(x):
        return fn(x, *rest)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        out = [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(x)]
        if hasattr(x, "_fields"):
            return type(x)(*out)
        return type(x)(out)
    return x


def _copy_to(tree, device):
    """Every tensor of `tree` copied to `device`: the copy never aliases."""
    return _tree_map(lambda t: t.to(device, copy=True), tree)


class _Bf16(NamedTuple):
    bits: np.ndarray  # a bf16 tensor's int16 view (numpy has no bf16)


def _to_host(tree):
    """A picklable copy of `tree`: numpy arrays, bf16 ones as `_Bf16`."""
    def leaf(t):
        t = t.detach().cpu()
        return _Bf16(t.view(torch.int16).numpy()) if t.dtype == torch.bfloat16 else t.numpy()
    return _tree_map(leaf, tree)


def _from_host(tree):
    if isinstance(tree, _Bf16):
        return torch.from_numpy(tree.bits).view(torch.bfloat16)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _from_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_from_host(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _generator_on(device: torch.device, kind: str, state: torch.Tensor) -> torch.Generator:
    """A generator on `device` that continues a generator of device type
    `kind` whose state is `state`: the same stream where the device types
    match; across CPU and card (whose generators differ in kind) one seeded
    from a hash of that state."""
    g = torch.Generator(device=device)
    if torch.device(device).type == kind:
        g.set_state(state)
    else:
        digest = hashlib.sha256(state.numpy().tobytes()).digest()
        g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _own_caches(st: arvc.ARVCState) -> arvc.ARVCState:
    """A copy of `st` whose KV caches the frame decode may update in place."""
    d = st.decode
    return st._replace(decode=d._replace(k_cache=d.k_cache.clone(),
                                         v_cache=d.v_cache.clone()))


class StreamSession:
    """One or `batch` real-time conversion streams.

    Usage:
        sess = StreamSession(converter, stream_cfg, ref_wavs)
        # or StreamSession(converter, stream_cfg, style=..., timbre=...,
        #                  ref_tokens=..., ref_codes=..., batch=B)
        for chunk in chunks_of_2048_samples:
            out = sess.process_chunk(chunk)   # (2048 * k,), or (B, 2048 * k)
    """

    def __init__(
        self,
        converter: Converter,
        scfg: Optional[StreamConfig] = None,
        ref_wavs=None,
        *,
        style=None,
        timbre=None,
        ref_tokens=None,
        ref_codes=None,
        sampling: Optional[SamplingConfig] = None,
        seed: int = 0,
        state_dtype=torch.float32,
        spk_noise=None,
        incremental: bool = True,
        batch: int = 1,
    ):
        """The prompt comes from `ref_wavs` (one 44.1 kHz reference or a
        list, for batch 1): its speaker embeddings, noise-mixed with
        `scfg.alpha` (`spk_noise`: the two standard normal draws, else drawn
        from the session's generator), and the codes and content tokens of
        the concatenated references; or precomputed, as `style`, `timbre`,
        `ref_tokens` and `ref_codes`, each with a leading axis of `batch`
        rows.  `state_dtype` is that of the LM KV cache and of the
        tokenizer's and vocoder's stream tails, as in the JAX package; bf16
        is its serving point.  `incremental=False` runs the window mode
        (batch 1)."""
        self.cv = converter
        self.cfg = converter.cfg
        self.scfg = scfg or self.cfg.stream
        self.sampling = sampling or self.cfg.sampling
        self.device = converter.device
        self.spf = self.cfg.samples_per_frame
        self.delay = self.scfg.delay
        self.incremental = incremental
        self.state_dtype = state_dtype
        self.batch = batch
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if not incremental and batch != 1:
            raise ValueError("StreamSession: the window mode serves one stream")

        lm_dtype = converter.arvc_params["embedding"].dtype
        dev = self.device
        if ref_wavs is not None:
            vc = VoiceConverter(converter)
            wavs = list(ref_wavs) if isinstance(ref_wavs, (list, tuple)) else [ref_wavs]
            style, timbre = vc.speaker_embeddings(wavs, self.scfg.alpha, self.generator,
                                                  noise=spk_noise)
            cat = torch.cat([vc._tensor(w) for w in wavs])[None]
            ref_codes = vc.audio_codes(cat)
            ref_tokens = vc.content_tokens(cat)
        if any(x is None for x in (style, timbre, ref_tokens, ref_codes)):
            raise ValueError("StreamSession: give ref_wavs, or style, timbre, ref_tokens "
                             "and ref_codes")
        on = lambda x: (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(dev)
        mp = self.scfg.max_prompt_frames
        self.ref_tokens = on(ref_tokens)[:, :mp]
        self.ref_codes = on(ref_codes)[:, :, :mp]
        self.style = on(style).float().to(lm_dtype)
        self.timbre = on(timbre).float().to(lm_dtype)
        if {self.ref_tokens.shape[0], self.ref_codes.shape[0], self.style.shape[0],
                self.timbre.shape[0]} != {batch}:
            raise ValueError(f"StreamSession: the prompt's rows must number batch={batch}")
        self.Tp = self.ref_tokens.shape[1]

        lm_state = self._prefill_prompt(self.ref_tokens, self.ref_codes)
        self._lm_pos_host = lm_state.decode.pos
        # the post-prompt state, stashed for the fast refill; the live state
        # gets its own caches because the frame decode updates them in place
        self._base_lm = lm_state if (incremental and self.scfg.fast_refill) else None
        self._base_pos_host = self._lm_pos_host
        self._shadow = None
        self._shadow_appended = 0

        k = self.scfg.decode_chunk_frames
        self.tok_ring_len = self.scfg.buffer_frames + max(self.delay, 1) + k + 8
        self.tokens_seen = 0
        self.frames_decoded = 0
        self.refill_count = 0
        self.delay_prefilled = self.delay == 0
        nq = self.cfg.arvc.decoder.num_codebooks
        if incremental:
            self._mel_consts = tokenizer_stream.mel_consts(self.cfg.tokenizer.mel, dev)
            self.fstate = FusedState(
                tok=tokenizer_stream.init_stream_state(
                    converter.tokenizer_params, self.cfg.tokenizer, batch, state_dtype, dev),
                lm=_own_caches(lm_state),
                voc=vocoder.init_stream_state(
                    converter.vocoder_params, self.cfg.vocoder, batch, state_dtype, dev),
                tok_ring=torch.zeros((batch, self.tok_ring_len), dtype=torch.int32,
                                     device=dev),
                code_ring=torch.zeros((batch, nq, self.tok_ring_len), dtype=torch.int32,
                                      device=dev),
            )
        else:
            self.state = lm_state
            self.wav_window = torch.zeros((1, self.scfg.encode_window_frames * self.spf),
                                          device=dev)
            self.tok_ring = torch.zeros((1, self.tok_ring_len), dtype=torch.int32, device=dev)
            W = self.scfg.decode_window_frames
            seed_codes = self.ref_codes[:, :, -W:]
            pad = W - seed_codes.shape[-1]
            self.code_window = torch.nn.functional.pad(seed_codes, (pad, 0))

    # ------------------------------------------------------------------
    # sessions made from this one
    # ------------------------------------------------------------------

    def transfer(self, converter: Converter, device=None) -> "StreamSession":
        """A copy of this session with all its state moved to `device` (the
        converter's unless given), bound to `converter`: the same model
        geometry, its program-selection flags free to differ.  The KV cache,
        ring, front and head layouts are migrated to the new flags with
        the four layout converters, as the JAX package's `transfer` does.
        The one-time prep (prompt prefill, delay prefill, warm-up chunks)
        can so run on the CPU and the stream continue on the card.  The
        generator continues where device types match, and is re-seeded from
        its state across CPU and card."""
        dev = torch.device(device) if device is not None else converter.device
        new = copy.copy(self)
        new.cv, new.cfg, new.device = converter, converter.cfg, dev
        # a partial background-refill shadow may be in the old layout: the
        # next boundary falls back to the one-shot refill
        new._shadow, new._shadow_appended = None, 0
        new.generator = _generator_on(dev, self.generator.device.type,
                                      self.generator.get_state())
        put = lambda t: _copy_to(t, dev)
        new.ref_tokens, new.ref_codes = put(self.ref_tokens), put(self.ref_codes)
        new.style, new.timbre = put(self.style), put(self.timbre)
        dcfg = converter.cfg.arvc.decoder
        relayout = lambda st: st._replace(decode=dual_ar.convert_cache_layout(st.decode, dcfg))
        if self._base_lm is not None:
            new._base_lm = relayout(put(self._base_lm))
        if self.incremental:
            new._mel_consts = tokenizer_stream.mel_consts(converter.cfg.tokenizer.mel, dev)
            fs = put(self.fstate)
            tcfg = converter.cfg.tokenizer
            tok = tokenizer_stream.convert_enc_layout(fs.tok, converter.tokenizer_params, tcfg)
            new.fstate = fs._replace(
                lm=relayout(fs.lm),
                tok=tok._replace(ring=tokenizer_stream.convert_ring_layout(
                    tok.ring, tcfg.transformer)),
                voc=vocoder.convert_head_layout(fs.voc, converter.cfg.vocoder.head))
        else:
            new.state = relayout(put(self.state))
            new.wav_window, new.tok_ring = put(self.wav_window), put(self.tok_ring)
            new.code_window = put(self.code_window)
        return new

    def snapshot(self) -> dict:
        """The whole stream state on the host: numpy trees, the host
        counters and the generator's state, picklable and portable across
        processes and devices.  Pair with `restore`."""
        if not self.incremental:
            raise ValueError("snapshot supports the incremental mode")
        return {
            "attrs": dict(
                cfg=self.cfg, scfg=self.scfg, sampling=self.sampling, spf=self.spf,
                delay=self.delay, incremental=True, state_dtype=self.state_dtype,
                batch=self.batch, tok_ring_len=self.tok_ring_len,
                tokens_seen=self.tokens_seen, frames_decoded=self.frames_decoded,
                refill_count=self.refill_count, delay_prefilled=self.delay_prefilled,
                _lm_pos_host=self._lm_pos_host, Tp=self.Tp,
                _base_pos_host=self._base_pos_host,
            ),
            "arrays": _to_host(dict(
                ref_tokens=self.ref_tokens, ref_codes=self.ref_codes, style=self.style,
                timbre=self.timbre, fstate=self.fstate, _base_lm=self._base_lm)),
            "generator": (self.generator.device.type, self.generator.get_state().numpy()),
        }

    @classmethod
    def restore(cls, converter: Converter, snap: dict, device=None) -> "StreamSession":
        """Rebuild a session from `snapshot()` onto `device` (the
        converter's unless given), bound to `converter`: the same geometry,
        its flags free to differ (the layouts migrate as in `transfer`)."""
        sess = object.__new__(cls)
        sess.__dict__.update(snap["attrs"])
        for k, v in _from_host(snap["arrays"]).items():
            setattr(sess, k, v)
        sess.cv, sess.device = converter, torch.device("cpu")
        sess.generator = torch.Generator()  # a stand-in: set from the snapshot below
        sess._shadow, sess._shadow_appended = None, 0
        new = sess.transfer(converter, device)
        kind, state = snap["generator"]
        new.generator = _generator_on(new.device, kind, torch.from_numpy(state))
        return new

    def with_cache_rows(self, rows: int) -> "StreamSession":
        """A copy whose LM KV cache holds `rows` rows, bound to a converter
        whose decoder `max_seq_len` is `rows`.  The frame decode reads the
        cache rows below the position only, so rows past every reachable
        position (prompt, refill window, delay prefill: checked here) change
        nothing; a smaller cache is less state a stream holds."""
        k = self.scfg.decode_chunk_frames
        need = max(
            2 * self.scfg.max_seq_frames + 2 * k + 2 * self.delay + 4,
            self._lm_state().decode.pos + 2 * k + 2,
            self._base_pos_host + 2 * self.scfg.buffer_frames + 2 * self.delay + 2,
            33 + 2 * self.Tp + 2 * self.delay + 2,  # prompt prefill rows
        )
        if rows < need:
            raise ValueError(f"cache rows {rows} < reachable max {need}")
        d = self.cfg.arvc.decoder
        new_cfg = dataclasses.replace(self.cfg, arvc=dataclasses.replace(
            self.cfg.arvc, decoder=dataclasses.replace(d, max_seq_len=rows)))

        def cut(st):
            # both layouts, per head (L, B, H, S, D) and flat (L, B, S, H*D),
            # carry S at axis -2; the slice is strided, the kernels take
            # dense rows
            dense = lambda c: c[..., :rows, :].clone(memory_format=torch.contiguous_format)
            return st._replace(decode=st.decode._replace(
                k_cache=dense(st.decode.k_cache), v_cache=dense(st.decode.v_cache)))

        new = self._copy()
        new.cfg = new_cfg
        new.cv = dataclasses.replace(self.cv, cfg=new_cfg)
        if self.incremental:
            new.fstate = new.fstate._replace(lm=cut(new.fstate.lm))
        else:
            new.state = cut(new.state)
        if self._base_lm is not None:
            new._base_lm = cut(new._base_lm)
        return new

    def fanout(self, B: int) -> "StreamSession":
        """Clone this prepared one-stream session into a B-stream session,
        every batched leaf of its state tiled B times: B callers converted
        to one target speaker share one prompt prefill.  The packed front
        and head states (batch 1 only) are unpacked first.  The batch axis
        of each leaf is the one where it differs from a B-stream state
        built on the `meta` device (no memory); the KV cache's is axis 1 of
        the decoder's layout, the LM's embeddings' axis 0."""
        if not (self.incremental and self.batch == 1):
            raise ValueError("fanout needs a one-stream incremental session")
        cv, cfg = self.cv, self.cfg
        fs = self.fstate._replace(
            tok=tokenizer_stream.convert_enc_layout(self.fstate.tok, cv.tokenizer_params,
                                                    cfg.tokenizer, target_batch=B),
            voc=vocoder.convert_head_layout(self.fstate.voc, cfg.vocoder.head,
                                            target_batch=B))

        def tile(x, t):
            if x.shape == t.shape:
                return x.clone()
            diff = [i for i, (a, b) in enumerate(zip(x.shape, t.shape)) if a != b]
            if not (x.ndim == t.ndim and len(diff) == 1 and x.shape[diff[0]] == 1
                    and t.shape[diff[0]] == B):
                raise ValueError(f"fanout: leaf {tuple(x.shape)} against {tuple(t.shape)}")
            return x.repeat_interleave(B, dim=diff[0])

        def lm_template(st):
            d = st.decode
            return st._replace(decode=d._replace(
                k_cache=d.k_cache.new_empty(d.k_cache.shape[:1] + (B,) + d.k_cache.shape[2:],
                                            device="meta"),
                v_cache=d.v_cache.new_empty(d.v_cache.shape[:1] + (B,) + d.v_cache.shape[2:],
                                            device="meta")),
                audio_emb=st.audio_emb.new_empty((B,) + st.audio_emb.shape[1:], device="meta"),
                ref_tail_emb=st.ref_tail_emb.new_empty((B,) + st.ref_tail_emb.shape[1:],
                                                       device="meta"))

        tmpl = FusedState(
            tok=tokenizer_stream.init_stream_state(cv.tokenizer_params, cfg.tokenizer, B,
                                                   self.state_dtype, "meta"),
            lm=lm_template(fs.lm),
            voc=vocoder.init_stream_state(cv.vocoder_params, cfg.vocoder, B,
                                          self.state_dtype, "meta"),
            tok_ring=fs.tok_ring.new_empty((B,) + fs.tok_ring.shape[1:], device="meta"),
            code_ring=fs.code_ring.new_empty((B,) + fs.code_ring.shape[1:], device="meta"))
        new = copy.copy(self)
        new.batch = B
        new._shadow, new._shadow_appended = None, 0
        new.generator = _generator_on(self.device, self.device.type,
                                      self.generator.get_state())
        rep0 = lambda x: x.repeat_interleave(B, dim=0)
        new.ref_tokens, new.ref_codes = rep0(self.ref_tokens), rep0(self.ref_codes)
        new.style, new.timbre = rep0(self.style), rep0(self.timbre)
        new.fstate = _tree_map(tile, fs, tmpl)
        if self._base_lm is not None:
            new._base_lm = _tree_map(tile, self._base_lm, lm_template(self._base_lm))
        return new

    def _copy(self) -> "StreamSession":
        """A shallow copy with state tensors and a generator of its own."""
        new = copy.copy(self)
        new._shadow, new._shadow_appended = None, 0
        new.generator = _generator_on(self.device, self.device.type,
                                      self.generator.get_state())
        if self.incremental:
            new.fstate = _copy_to(self.fstate, self.device)
        else:
            new.state = _copy_to(self.state, self.device)
            new.wav_window, new.tok_ring = self.wav_window.clone(), self.tok_ring.clone()
            new.code_window = self.code_window.clone()
        if self._base_lm is not None:
            new._base_lm = _copy_to(self._base_lm, self.device)
        return new

    # ------------------------------------------------------------------
    # LM programs
    # ------------------------------------------------------------------

    def _prefill_prompt(self, tokens, codes, cache_dtype=None) -> arvc.ARVCState:
        return arvc.prefill_prompt(self.cv.arvc_params, self.cfg.arvc, tokens, codes,
                                   self.style, self.timbre, self.delay,
                                   cache_dtype or self.state_dtype)

    def _prefill_delay(self, lm: arvc.ARVCState, tok_ring: torch.Tensor) -> arvc.ARVCState:
        return arvc.prefill_src_condition4delay(
            self.cv.arvc_params, self.cfg.arvc, lm, tok_ring[:, -self.delay :], self.delay)

    def _prefill_history(self, base: arvc.ARVCState, n: int) -> arvc.ARVCState:
        return arvc.prefill_history(self.cv.arvc_params, self.cfg.arvc, base,
                                    self._recent_tokens(n), self._recent_codes(n),
                                    self.delay)

    def _noise(self):
        """Gumbel rows for one frame of every stream, -log(-log(U)) drawn on
        the device, in the shapes `dual_ar.frame_noise_shapes` gives: over
        the sampling window where the windowed sampler runs, over the
        vocabulary where a kernel's exact sampler does; the semantic rows
        first, then the codebooks'."""
        if self.sampling.greedy:
            return None, None
        sem, fast = dual_ar.frame_noise_shapes(self.cv.arvc_params["model"],
                                               self.cfg.arvc.decoder, self.sampling,
                                               self.batch)
        return (arvc.gumbel(sem, self.generator, self.device),
                arvc.gumbel(fast, self.generator, self.device))

    def _decode_frames(self, lm: arvc.ARVCState, toks: torch.Tensor):
        """One `decode_one` a token of toks (B, k): (state', codes (B, nq, k))."""
        frames = []
        for t in range(toks.shape[1]):
            gs, gf = self._noise()
            lm, codes = arvc.decode_one(self.cv.arvc_params, self.cfg.arvc, lm,
                                        toks[:, t : t + 1], self.sampling, gs, gf)
            frames.append(codes)
        return lm, torch.stack(frames, dim=-1)

    def _lm_state(self) -> arvc.ARVCState:
        return self.fstate.lm if self.incremental else self.state

    @property
    def truncation_count(self) -> int:
        """Nucleus-truncation events of the windowed semantic sampler (its
        top-k window held less than top_p of the probability) carried by the
        live LM state; as in the JAX package, a prompt refill swaps in a
        state that carries the count of the post-prompt state.  Reading it
        waits for the device."""
        return int(self._lm_state().decode.trunc)

    # ------------------------------------------------------------------
    # the chunk step
    # ------------------------------------------------------------------

    def process_chunk(self, chunk) -> np.ndarray:
        """One chunk of decode_chunk_frames * 2048 samples a stream in, as
        many out (zeros while the delay fills): (n,) at batch 1, (B, n)
        above."""
        if not self.incremental:
            return self._process_chunk_window(chunk)[0].float().cpu().numpy()
        out = self._process_chunk_incremental(chunk).float().cpu().numpy()
        return out[0] if self.batch == 1 else out

    def process_chunk_async(self, chunk) -> torch.Tensor:
        """`process_chunk` without any host synchronisation: the output
        stays a float32 tensor on the device ((n,) or (B, n)), and the input
        goes to the card from pinned memory without waiting.  A caller
        fetches it from another thread (runtime/realtime.py) while the next
        chunks are queued."""
        if not self.incremental:
            raise ValueError("the asynchronous chunk step needs the incremental mode")
        wav = self._process_chunk_incremental(chunk).float()
        return wav[0] if self.batch == 1 else wav

    def _upload(self, chunk, n: int) -> torch.Tensor:
        """The chunk as (B, n) float32 on the device; numpy input goes
        through pinned memory (no wait on the card)."""
        if torch.is_tensor(chunk):
            return chunk.to(self.device, torch.float32).reshape(self.batch, n)
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32).reshape(self.batch, n))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _process_chunk_incremental(self, chunk) -> torch.Tensor:
        k = self.scfg.decode_chunk_frames
        n = k * self.spf
        tstate, toks = tokenizer_stream.encode_stream(
            self.cv.tokenizer_params, self.cfg.tokenizer, self.fstate.tok,
            self._upload(chunk, n), self._mel_consts)
        ring = torch.cat([self.fstate.tok_ring[:, toks.shape[1]:], toks], dim=1)
        self.fstate = self.fstate._replace(tok=tstate, tok_ring=ring)
        self.tokens_seen += k

        if self.tokens_seen <= self.delay or not self.delay_prefilled:
            if self.tokens_seen >= self.delay and not self.delay_prefilled:
                self.fstate = self.fstate._replace(
                    lm=self._prefill_delay(self.fstate.lm, self.fstate.tok_ring))
                self._lm_pos_host += 2 * self.delay - 1
                self.delay_prefilled = True
            return torch.zeros((self.batch, n), dtype=torch.float32, device=self.device)

        lm, codes = self._decode_frames(self.fstate.lm, toks)
        code_ring = torch.cat([self.fstate.code_ring[:, :, k:], codes], dim=-1)
        voc, wav = vocoder.decode_stream(self.cv.vocoder_params, self.cfg.vocoder,
                                         self.fstate.voc, codes)
        self.fstate = self.fstate._replace(lm=lm, code_ring=code_ring, voc=voc)
        self.frames_decoded += k
        self._lm_pos_host += 2 * k
        r = self._lm_pos_host // 2
        msf = self.scfg.max_seq_frames
        b = self.scfg.buffer_frames
        if self._base_lm is not None and self.scfg.background_refill and b % k == 0:
            # the chunks whose end position r satisfies r_swap - r < b form
            # the refill window: append this chunk's k pairs to the shadow
            rem = msf - r
            if rem <= 0 or (-(-rem // k)) * k < b:
                if self._shadow is None:
                    self._shadow, self._shadow_appended = self._base_lm, 0
                self._shadow = self._prefill_history(self._shadow, k)
                self._shadow_appended += k
            elif self._shadow is not None:
                self._shadow, self._shadow_appended = None, 0
        if r >= msf:
            self._finish_refill()
        return wav

    def _finish_refill(self):
        """Boundary chunk: swap in the background shadow if it holds exactly
        buffer_frames appended pairs (it then is the refilled state), else
        run the one-shot refill."""
        self.refill_count += 1
        b = self.scfg.buffer_frames
        if self._shadow is not None and self._shadow_appended == b:
            lm = self._shadow
            self._lm_pos_host = self._base_pos_host + 2 * b
            if self.delay > 0:
                lm = self._prefill_delay(lm, self.fstate.tok_ring)
                self._lm_pos_host += 2 * self.delay - 1
            self.fstate = self.fstate._replace(lm=lm)
        else:
            self._refill_incremental()
        self._shadow, self._shadow_appended = None, 0

    def warm_refill_programs(self):
        """Run every program a refill boundary can run (the one-shot refill,
        the background history append, the delay prefill) against
        throwaway state, then restore the live state; on the card also
        build and load every kernel library, so that no chunk of the live
        stream waits for a compiler."""
        if self.device.type == "cuda":
            for name in _build.SIGNATURES:
                _build.load(name)
        saved = (self.fstate, self._lm_pos_host, self._shadow, self._shadow_appended)
        try:
            self._refill_incremental()
            if self._base_lm is not None and self.scfg.background_refill:
                self._prefill_history(self._base_lm, self.scfg.decode_chunk_frames)
        finally:
            (self.fstate, self._lm_pos_host, self._shadow, self._shadow_appended) = saved

    def _refill_incremental(self):
        b = self.scfg.buffer_frames
        if self._base_lm is not None:
            lm = self._prefill_history(self._base_lm, b)
        else:
            lm = self._prefill_prompt(
                torch.cat([self.ref_tokens, self._recent_tokens(b)], dim=-1),
                torch.cat([self.ref_codes, self._recent_codes(b)], dim=-1))
        self._lm_pos_host = self._base_pos_host + 2 * b
        if self.delay > 0:
            lm = self._prefill_delay(lm, self.fstate.tok_ring)
            self._lm_pos_host += 2 * self.delay - 1
        self.fstate = self.fstate._replace(lm=lm)

    def _recent_tokens(self, b):
        if self.delay > 0:
            return self.fstate.tok_ring[:, -b - self.delay : -self.delay]
        return self.fstate.tok_ring[:, -b:]

    def _recent_codes(self, b):
        return self.fstate.code_ring[:, :, -b:]

    # ------------------------------------------------------------------
    # window mode
    # ------------------------------------------------------------------

    def _process_chunk_window(self, chunk) -> torch.Tensor:
        """The reference's chunk step: re-encode the rolling window with the
        offline tokenizer, decode the chunk's frames (the slow-step and
        fast-loop kernels at batch 1 under their flags), then decode the
        code window with the offline vocoder.  Returns (1, n)."""
        k = self.scfg.decode_chunk_frames
        n = k * self.spf
        f32 = self.cv.float32_trees
        self.wav_window = torch.cat([self.wav_window[:, n:], self._upload(chunk, n)], dim=1)
        toks = tokenizer.encode(f32["tokenizer_params"], self.cfg.tokenizer, self.wav_window)
        new_toks = toks[:, -k:]
        self.tok_ring = torch.cat([self.tok_ring[:, k:], new_toks], dim=1)
        self.tokens_seen += k
        silence = torch.zeros((1, n), dtype=torch.float32, device=self.device)
        if self.tokens_seen < self.delay:
            return silence
        if not self.delay_prefilled:
            self.state = self._prefill_delay(self.state, self.tok_ring)
            self.delay_prefilled = True
            return silence
        self.state, codes = self._decode_frames(self.state, new_toks)
        self.code_window = torch.cat([self.code_window[:, :, k:], codes], dim=-1)
        self.frames_decoded += k
        if self.state.decode.pos // 2 >= self.scfg.max_seq_frames:
            self._refill_window()
        wav = vocoder.decode(f32["vocoder_params"], self.cfg.vocoder, self.code_window)
        return wav[:, -n:]

    def _refill_window(self):
        self.refill_count += 1
        b = self.scfg.buffer_frames
        codes = torch.cat([self.ref_codes, self.code_window[:, :, -b:]], dim=-1)
        if self.delay > 0:
            hist = self.tok_ring[:, -b - self.delay : -self.delay]
        else:
            hist = self.tok_ring[:, -b:]
        # the window mode refills into a float32 cache, as the JAX package's
        self.state = self._prefill_prompt(torch.cat([self.ref_tokens, hist], dim=-1), codes,
                                          torch.float32)
        if self.delay > 0:
            self.state = self._prefill_delay(self.state, self.tok_ring)

    # ------------------------------------------------------------------

    def stream_file(self, src_wav: np.ndarray) -> np.ndarray:
        """Simulated streaming over a file: left-padded to whole chunks,
        chunk by chunk through `process_chunk`."""
        n = self.scfg.decode_chunk_frames * self.spf
        src = np.pad(np.asarray(src_wav, np.float32), ((-len(src_wav)) % n, 0))
        return np.concatenate([self.process_chunk(src[i : i + n])
                               for i in range(0, len(src), n)])

