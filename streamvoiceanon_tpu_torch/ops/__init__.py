"""The port's hand-written CUDA kernels, one wrapper module each."""


def kernel_wrappers():
    """The six kernel wrappers by key; each counts its launches in
    `.launches`.  The one list of them: `utils/profiling` reports their
    launches over a traced stretch, `chip_smoke.py` checks them per phase."""
    from streamvoiceanon_tpu_torch.ops.attention import decode_attention
    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step
    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step
    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step

    return {"slow": slow_decode_step, "fast": fast_decode, "ring": wt_stream_step,
            "head": head_stream_step, "enc": encoder_front_step, "attn": decode_attention}
