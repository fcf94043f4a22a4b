"""Typed configuration tree of the PyTorch port.

The port's own copy of `streamvoiceanon_tpu.config` (the port imports
nothing of the JAX package): the same frozen dataclasses with the same
defaults, which reproduce the published model family
`config_firefly_arvcasr_8192_delay0_8`.  The flag names are kept, so one
configuration describes both packages.  `tpu_optimized` is the program
set of the main path; `fast_slow_config` keeps the tokenizer ring and the
HiFiGAN head on their plain paths; `all_five` adds the ConvNeXt encoder
kernel and `per_head_decode` swaps the slow-step kernel for the per-head
decode-attention kernel.  `PRESETS` are the live app's named operating
points.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# DSP front-end
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MelConfig:
    """Causal log-mel front end (cf. reference modules/vqgan/spectrogram.py:7-130)."""

    sample_rate: int = 44100
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 512
    n_mels: int = 160
    f_min: float = 0.0
    f_max: Optional[float] = None  # None -> sample_rate // 2

    @property
    def fmax(self) -> float:
        return float(self.sample_rate // 2) if self.f_max is None else self.f_max


# ---------------------------------------------------------------------------
# ConvNeXt backbone
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvNeXtConfig:
    """Causal ConvNeXt encoder (cf. reference modules/vqgan/modules/firefly.py:443-517)."""

    input_channels: int = 160
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (128, 256, 384, 512)
    kernel_size: int = 7
    mlp_ratio: float = 4.0
    layer_scale_init_value: float = 1e-6
    gin_channels: int = 0  # optional global conditioning (firefly.py:498)
    drop_path_rate: float = 0.0


# ---------------------------------------------------------------------------
# Transformers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WindowedTransformerConfig:
    """Window-limited causal transformer used inside the tokenizer
    (cf. reference modules/vqgan/windowed_transformer.py:21-43,275-354)."""

    block_size: int = 2048
    n_layer: int = 8
    n_head: int = 8
    dim: int = 512
    intermediate_size: int = 1536
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    layer_scale_init: float = 1e-2
    window_size: Optional[int] = 512
    causal: bool = True
    # depthwise-conv (LConv1d) branch between attention and FFN
    # (windowed_transformer.py:34-35,141,197-234; default off, matching the
    # deployed tokenizer config)
    dw_conv: bool = False
    conv_kernel_size: int = 5
    # Streaming ring step on its kernel (ops/wt_stream.py), with a flat
    # circular absolute-rope ring layout (L, B, W, n_head*head_dim).  The
    # kernel runs at batch 1; batch > 1 runs the plain circular step.
    use_pallas_stream: bool = False
    # rope-table rows for the circular layout: effective positions live in
    # [W, rope_table_rows); the ring is re-based (one elementwise rotation)
    # every rope_table_rows - window_size tokens.  Must be > 2 * window_size.
    rope_table_rows: int = 4096


@dataclass(frozen=True)
class DualARConfig:
    """Dual-autoregressive token LM (cf. reference modules/dual_ar_stream.py:24-129
    and configs/hydra_arcs/vc/firefly_arvc_bsq_8192_delay0_8.yaml)."""

    vocab_size: int = 8192  # semantic/content token vocab, no eos
    n_layer: int = 12
    n_head: int = 12
    dim: int = 768
    intermediate_size: int = 2304
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dropout: float = 0.1
    tie_word_embeddings: bool = False
    attention_qkv_bias: bool = False

    codebook_size: int = 1000
    num_codebooks: int = 8

    # fast (per-frame codebook) transformer
    n_fast_layer: int = 4
    fast_dim: int = 768
    fast_n_head: int = 12
    fast_n_local_heads: int = -1
    fast_head_dim: int = 64
    fast_intermediate_size: int = 2304

    # delay machinery: a tuple means the model was trained on a range of
    # delays and the runtime may pick any of them (dual_ar_stream.py:649-657)
    delay: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7, 8)

    cond_input_dim: int = 768
    style_input_dim: int = 192

    # The frame decode's attention on the per-head update+attend kernel
    # (ops/attention.py), with a per-head (L, B, H, S, head_dim) KV cache
    # (the JAX package pads its head dim to 128 lanes; the port does not),
    # then the output head and the windowed sampler.  Any batch (the kernel
    # runs over B x n_head heads); MHA only, GQA raises.
    use_pallas_decode: bool = False

    # Run the 8-step fast codebook loop (4 fast layers, exact full-vocab
    # nucleus sampling, next-frame audio embedding) on its kernel
    # (ops/fast_decode.py).  Batch 1 and MHA; otherwise the loop runs plain,
    # as the JAX package's XLA path.
    use_pallas_fast_decode: bool = False

    # Unroll factor of the JAX package's decode layer scan (unused here).
    decode_layer_unroll: int = 1

    # Run the 12-layer two-token slow step (plus final norm, output head
    # and semantic sampling) on its kernel (ops/slow_decode.py).  Changes
    # the KV-cache layout to flat (L, B, S, n_head*head_dim) rows; prefill
    # writes the same rows.  The kernel runs at batch 1 with MHA and an
    # untied head without bias; otherwise the layers run plain on the flat
    # rows.
    use_pallas_slow_decode: bool = False

    def __post_init__(self):
        if self.n_local_heads == -1:
            object.__setattr__(self, "n_local_heads", self.n_head)
        if self.fast_n_local_heads == -1:
            object.__setattr__(self, "fast_n_local_heads", self.fast_n_head)
        if self.use_pallas_slow_decode and self.use_pallas_decode:
            raise ValueError(
                "use_pallas_slow_decode and use_pallas_decode imply different "
                "KV-cache layouts; enable at most one")

    @property
    def max_delay(self) -> int:
        return max(self.delay) if isinstance(self.delay, tuple) else int(self.delay)


@dataclass(frozen=True)
class ARVCConfig:
    """Composition wrapper around the dual-AR LM
    (cf. reference modules/arvc_wrapper.py:7-126)."""

    decoder: DualARConfig = field(default_factory=DualARConfig)
    context_dim: int = 128  # timbre latent dim
    style_dim: int = 192  # CAMPPlus style vector dim
    model_dim: int = 768
    spk_condition: bool = True
    spk_condition_len: int = 33  # 32 timbre latents + 1 style vec


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BSQConfig:
    """Downsampling binary-spherical quantizer of the content tokenizer
    (cf. reference modules/vqgan/modules/bsq_no_upsample.py:20-112, bsq.py:128-496)."""

    input_dim: int = 512
    n_groups: int = 1
    codebook_size: int = 8192  # -> 13 bits
    downsample_factor: Tuple[int, ...] = (2, 2)

    @property
    def codebook_bits(self) -> int:
        b = self.codebook_size.bit_length() - 1
        assert (1 << b) == self.codebook_size, "codebook_size must be a power of 2"
        return b


@dataclass(frozen=True)
class FSQConfig:
    """Downsampling grouped-residual finite scalar quantizer of the vocoder
    (cf. reference modules/vqgan/modules/fsq.py:19-116 and the repo's own FSQ
    implementation modules/bicodec_speaker_encoder/fsq/finite_scalar_quantization.py)."""

    input_dim: int = 512
    n_groups: int = 8
    n_codebooks: int = 1  # residual quantizers per group
    levels: Tuple[int, ...] = (8, 5, 5, 5)  # prod = 1000 entries / codebook
    downsample_factor: Tuple[int, ...] = (2, 2)

    @property
    def codebook_size(self) -> int:
        out = 1
        for l in self.levels:
            out *= l
        return out


# ---------------------------------------------------------------------------
# Model-level configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFiGAN vocoder head (cf. reference modules/vqgan/modules/firefly.py:222-301
    and configs/hydra_arcs/vocoders/firefly_gan_vq.yaml)."""

    num_mels: int = 512  # input channels (quantizer output dim)
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_initial_channel: int = 512
    pre_conv_kernel_size: int = 13
    post_conv_kernel_size: int = 13
    hop_length: int = 512
    # The whole streaming head on its fused kernel (ops/hifigan.py), with
    # packed per-stage tail buffers (PackedHeadState).  Batch 1 and
    # k == 2 * stride upsamples; otherwise the dict-of-tails path.
    use_pallas_stream: bool = False


@dataclass(frozen=True)
class VocoderConfig:
    """Firefly codec: mel->ConvNeXt->FSQ (encode) / FSQ->HiFiGAN (decode)
    (cf. reference modules/vqgan/modules/firefly.py:520-607)."""

    mel: MelConfig = field(default_factory=MelConfig)
    backbone: ConvNeXtConfig = field(default_factory=ConvNeXtConfig)
    quantizer: FSQConfig = field(default_factory=FSQConfig)
    head: HiFiGANConfig = field(default_factory=HiFiGANConfig)

    @property
    def downsample_factor(self) -> int:
        out = 1
        for f in self.quantizer.downsample_factor:
            out *= f
        return out

    @property
    def samples_per_frame(self) -> int:
        return self.mel.hop_length * self.downsample_factor  # 2048


@dataclass(frozen=True)
class TokenizerConfig:
    """Causal BSQ content tokenizer
    (cf. reference modules/vqgan/modules/firefly_encoder.py:510-598 and
    configs/hydra_arcs/speech_tokenizers/causal-encoder-lfq-8192.yaml)."""

    mel: MelConfig = field(default_factory=MelConfig)
    backbone: ConvNeXtConfig = field(default_factory=ConvNeXtConfig)
    quantizer: BSQConfig = field(default_factory=BSQConfig)
    transformer: WindowedTransformerConfig = field(
        default_factory=WindowedTransformerConfig
    )
    # The ConvNeXt front (stem, blocks, transitions, downsamples) on its
    # kernel (ops/convnext_enc.py), with a packed tail state.  Batch 1;
    # batch > 1 runs the dict path on the unpacked state.
    use_pallas_encoder: bool = False

    # training-only distillation head predicting w2v-BERT features
    head: ConvNeXtConfig = field(
        default_factory=lambda: ConvNeXtConfig(
            input_channels=512,
            depths=(3, 3, 3, 3),
            dims=(640, 768, 896, 1024),
            kernel_size=7,
            gin_channels=192,
        )
    )

    @property
    def downsample_factor(self) -> int:
        out = 1
        for f in self.quantizer.downsample_factor:
            out *= f
        return out


@dataclass(frozen=True)
class CAMPPlusConfig:
    """CAM++ D-TDNN style encoder (cf. reference modules/campplus/DTDNN.py:50-138)."""

    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_kernels: Tuple[int, ...] = (3, 3, 3)
    block_dilations: Tuple[int, ...] = (1, 2, 2)


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """SparkTTS/BiCodec timbre encoder
    (cf. reference modules/bicodec_speaker_encoder/speaker_encoder.py:34-153)."""

    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 640
    hop_length: int = 320
    n_mels: int = 128
    mel_fmin: float = 10.0
    mel_fmax: Optional[float] = None
    input_dim: int = 128  # mel bins fed to ECAPA
    out_dim: int = 512
    latent_dim: int = 128
    token_num: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    fsq_num_quantizers: int = 1
    ecapa_channels: int = 512


# ---------------------------------------------------------------------------
# Runtime / streaming
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamplingConfig:
    """Sampling defaults follow reference dual_ar_stream.py:1099-1106."""

    temperature: float = 0.7
    top_p: float = 0.7
    repetition_penalty: float = 1.0  # penalty disabled on the runtime path
    greedy: bool = False  # argmax decoding (parity/testing mode)
    # nucleus filter runs over the top-k logits only (exact whenever the
    # nucleus fits in k; far cheaper than a full-vocab sort on TPU);
    # 0 = exact full-vocab sort
    top_k_window: int = 64


@dataclass(frozen=True)
class StreamConfig:
    """Streaming state-machine geometry
    (cf. reference evaluations/infer_arvc.py:443-596 defaults)."""

    encode_window_frames: int = 128
    decode_window_frames: int = 64
    max_prompt_frames: int = 256
    max_seq_frames: int = 768
    buffer_frames: int = 32
    decode_chunk_frames: int = 1
    delay: int = 2
    alpha: float = 1.0  # speaker-embedding noise-mixing coefficient
    # incremental-mode refill strategy: stash the post-prompt LM state once
    # and run a small fixed-shape history prefill (buffer_frames pairs) at
    # each refill boundary instead of re-running the full padded-prompt
    # prefill on the hot path (arvc.prefill_history; exact-equal by
    # construction — tests/test_streaming_integration.py)
    fast_refill: bool = True
    # spread the refill over the window BEFORE the boundary: rebuild the
    # recycled LM state incrementally (one small history-append program per
    # chunk for the last buffer_frames frames, exploiting prefill_history's
    # chaining property) and swap at the boundary — the hot path never runs
    # a multi-frame prefill.  Exact-equal to the monolithic refill
    # (tests/test_streaming_integration.py); requires fast_refill and
    # buffer_frames % decode_chunk_frames == 0 (else falls back per boundary)
    background_refill: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle for the full conversion pipeline."""

    sample_rate: int = 44100
    resample_rate: int = 16000  # speaker-encoder branch rate
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    arvc: ARVCConfig = field(default_factory=ARVCConfig)
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    speaker: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    @property
    def samples_per_frame(self) -> int:
        return self.vocoder.samples_per_frame  # 2048


# Named operating presets (cf. reference configs/presets.json:1-26).
PRESETS = {
    "max_privacy": StreamConfig(alpha=0.0, delay=2),
    "balanced": StreamConfig(alpha=0.5, delay=2),
    "max_quality": StreamConfig(alpha=1.0, delay=4),
    "low_latency": StreamConfig(alpha=0.7, delay=1),
}


def preset(name: str) -> StreamConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]


def replace(cfg, **kwargs):
    """dataclasses.replace that works through frozen configs."""
    return dataclasses.replace(cfg, **kwargs)


def from_fields(cfg):
    """Rebuild a configuration tree from config objects of another package
    whose classes have these names and fields (the JAX package's), so one
    configuration drives both."""
    if dataclasses.is_dataclass(cfg):
        cls = globals()[type(cfg).__name__]
        return cls(**{f.name: from_fields(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)})
    if isinstance(cfg, tuple):
        return tuple(from_fields(x) for x in cfg)
    return cfg


def fast_slow_config(cfg: PipelineConfig) -> PipelineConfig:
    """The dual-AR slow step and the fast codebook loop on their
    hand-written kernels (flat KV-cache layout), with the tokenizer's
    windowed transformer and the HiFiGAN head on their plain paths."""
    return replace(
        cfg,
        arvc=replace(cfg.arvc, decoder=replace(
            cfg.arvc.decoder,
            use_pallas_fast_decode=True,
            use_pallas_slow_decode=True)),
    )


def tpu_optimized(cfg: PipelineConfig) -> PipelineConfig:
    """The program set the JAX package serves with, and the port's main
    path: the two LM kernels plus the windowed-transformer ring kernel
    (flat circular ring) and the fused HiFiGAN head (packed state), all
    four on hand-written kernels.  The ConvNeXt encoder kernel
    (`use_pallas_encoder`) and the per-head decode cache
    (`use_pallas_decode`) stay off, as in the JAX package; `all_five` and
    `per_head_decode` turn them on."""
    return replace(
        cfg,
        arvc=replace(cfg.arvc, decoder=replace(
            cfg.arvc.decoder,
            use_pallas_fast_decode=True,
            use_pallas_slow_decode=True)),
        tokenizer=replace(cfg.tokenizer, transformer=replace(
            cfg.tokenizer.transformer, use_pallas_stream=True)),
        vocoder=replace(cfg.vocoder, head=replace(
            cfg.vocoder.head, use_pallas_stream=True)),
    )


def all_five(cfg: PipelineConfig) -> PipelineConfig:
    """`tpu_optimized` plus the ConvNeXt encoder kernel with its packed
    state (`use_pallas_encoder`): the JAX package's "all five" set."""
    t = tpu_optimized(cfg)
    return replace(t, tokenizer=replace(t.tokenizer, use_pallas_encoder=True))


def per_head_decode(cfg: PipelineConfig) -> PipelineConfig:
    """`tpu_optimized` with the per-head KV cache: the frame decode's layer
    loop on the decode-attention kernel (`use_pallas_decode`) in place of
    the slow-step kernel, then the windowed sampler and the fast loop."""
    t = tpu_optimized(cfg)
    return replace(t, arvc=replace(t.arvc, decoder=replace(
        t.arvc.decoder, use_pallas_slow_decode=False, use_pallas_decode=True)))
