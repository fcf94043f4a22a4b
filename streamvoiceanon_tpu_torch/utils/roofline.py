"""Static FLOPs / device-memory-byte roofline of one streaming chunk, as the
JAX package's utils/roofline.py.

For each stage of the real-time path (content encode, LM slow step, LM fast
codebook loop, vocode) it models

* weight bytes: exact, summed from the parameter trees the stage reads.  A
  stage counts the bytes of its logical weights once: the converter's
  kernel-layout copies (`enc_packed`, `enc_units`, `head_packed`) and its
  `float32_trees` are other layouts of the same weights, never added;
* state bytes: exact, from the stream-state tensors as the port allocates
  them (KV caches, the tokenizer's ring, the conv tails): the flat or
  per-head KV cache (the port keeps the per-head head dim unpadded), the
  packed tails of the fused front and head where the program set runs
  them.  The full arrays count, as the JAX package counts them: the decode
  programs read whole static-shape arrays;
* FLOPs: 2 x weight elements x positions at that module's rate, plus the
  attention terms from the config's geometry (the same model as the JAX
  package's).

`chunk_roofline` combines the model with a measured per-chunk compute time
into achieved GB/s, the share of the peak memory rate and MFU.  Peaks come
from the port's own table, keyed by substrings of
`torch.cuda.get_device_name()`: public figures of NVIDIA's cards (dense
bf16 tensor-core FLOP/s, float32 CUDA-core FLOP/s, HBM bytes a second).

The workload modelled is one 46.44 ms frame of the streaming loop: 2048
samples -> 4 mel frames -> 1 content token -> 2-token slow step + 8-step
fast loop -> 2048 samples.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

MEL_FRAMES_PER_CHUNK = 4  # hop 512 at 44.1 kHz, 2048-sample chunk
TOKENS_PER_CHUNK = 1


def _leaves(tree):
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def tree_bytes(tree) -> int:
    """Bytes of the tensors (and numpy arrays) of a nested dict / list /
    NamedTuple tree; other leaves (ints, None) count nothing."""
    return int(sum(x.numel() * x.element_size() if torch.is_tensor(x)
                   else x.size * x.dtype.itemsize for x in _leaves(tree)))


def tree_elems(tree) -> int:
    return int(sum(x.numel() if torch.is_tensor(x) else x.size for x in _leaves(tree)))


# ---------------------------------------------------------------------------
# the card's peaks, by a substring of its name (most specific first)
# ---------------------------------------------------------------------------

_PEAKS = (
    # (substring, dense bf16 FLOP/s, float32 CUDA-core FLOP/s, HBM bytes/s)
    ("h100", 989e12, 67e12, 3.35e12),  # H100 SXM (80GB HBM3)
)


def device_peaks(device: Union[str, torch.device, None] = None) -> Optional[Dict]:
    """Peak dense-bf16 and float32 FLOP/s and memory rate of a card, given
    its name (`torch.cuda.get_device_name()`) or a CUDA device; None for
    the CPU or a card not in the table (numbers then report GB/s without
    a share of the peak)."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        kind = device
    else:
        dev = torch.device(device) if device is not None else None
        if dev is None:
            if not torch.cuda.is_available():
                return None
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type != "cuda":
            return None
        kind = torch.cuda.get_device_name(dev)
    low = kind.lower()
    for sub, bf16, fp32, bw in _PEAKS:
        if sub in low:
            return {"device_kind": kind, "bf16_flops": bf16, "fp32_flops": fp32,
                    "hbm_bytes_s": bw}
    return None


# ---------------------------------------------------------------------------
# per-stage models
# ---------------------------------------------------------------------------


def encode_stage(cfg, tok_params, tok_state=None) -> Dict:
    """Content encode of one chunk: mel -> ConvNeXt backbone (4 mel
    positions) -> stride-2 downsamples -> windowed transformer (1 token)
    -> LFQ.  The fused front's packed copies of the backbone are not
    counted beside it."""
    p = tok_params
    used = {k: p[k] for k in ("backbone", "downsample", "pre_module", "lfq") if k in p}
    w_bytes = tree_bytes(used)
    state_bytes = tree_bytes(tok_state) if tok_state is not None else 0

    t = cfg.tokenizer
    f_conv = 2 * tree_elems(p["backbone"]) * MEL_FRAMES_PER_CHUNK
    f_down = 0
    pos = MEL_FRAMES_PER_CHUNK
    for dlayer, fct in zip(p["downsample"], t.quantizer.downsample_factor):
        pos //= fct
        f_down += 2 * tree_elems(dlayer) * pos
    wt = t.transformer
    f_wt = 2 * tree_elems(p["pre_module"]) * TOKENS_PER_CHUNK
    window = wt.window_size or wt.block_size
    f_wt += 4 * window * wt.n_head * wt.head_dim * wt.n_layer
    f_lfq = 2 * tree_elems(p["lfq"]) * TOKENS_PER_CHUNK
    return {"flops": f_conv + f_down + f_wt + f_lfq,
            "weight_bytes": w_bytes, "state_bytes": state_bytes}


def slow_stage(cfg, arvc_params, decode_state=None) -> Dict:
    """LM slow step: 2 tokens through the slow stack, the final norm and
    the output head; the KV traffic is the whole cache of either layout."""
    m = arvc_params["model"]
    used = {k: m[k] for k in ("layers", "norm", "output") if k in m}
    w_bytes = tree_bytes(used)
    d = cfg.arvc.decoder
    kv_bytes = 0
    if decode_state is not None:
        kv_bytes = tree_bytes(decode_state.k_cache) + tree_bytes(decode_state.v_cache)
    f = 2 * tree_elems(used) * 2
    f += 4 * d.max_seq_len * d.n_head * d.head_dim * d.n_layer * 2
    return {"flops": f, "weight_bytes": w_bytes, "state_bytes": kv_bytes}


def fast_stage(cfg, arvc_params) -> Dict:
    """LM fast codebook loop: 8 steps over the fast stack.  The fast-loop
    kernel (`use_pallas_fast_decode`) reads the weights once a frame; the
    plain loop reads them every step."""
    m = arvc_params["model"]
    used = {k: m[k] for k in ("fast_layers", "fast_norm", "fast_output") if k in m}
    d = cfg.arvc.decoder
    nq = d.num_codebooks
    reads = 1 if d.use_pallas_fast_decode else nq
    w_bytes = tree_bytes(used) * reads
    f = 2 * tree_elems(used) * nq
    f += 4 * nq * d.fast_n_head * d.fast_head_dim * d.n_fast_layer * nq // 2
    return {"flops": f, "weight_bytes": w_bytes, "state_bytes": 0}


def vocode_stage(cfg, voc_params, voc_state=None) -> Dict:
    """Vocode one frame: FSQ decode -> upsample x4 -> HiFiGAN head, FLOPs
    position-exact per stage (1 -> 4 mel positions through the upsample,
    then x upsample_rates through the head to 2048 samples).  The fused
    head's packed copy is not counted beside `head`."""
    p = voc_params
    used = {k: p[k] for k in ("fsq", "upsample", "head") if k in p}
    w_bytes = tree_bytes(used)
    state_bytes = tree_bytes(voc_state) if voc_state is not None else 0

    h = cfg.vocoder.head
    f = 2 * tree_elems(p["fsq"]) * TOKENS_PER_CHUNK
    pos = TOKENS_PER_CHUNK
    for ulayer, fct in zip(p["upsample"], reversed(cfg.vocoder.quantizer.downsample_factor)):
        pos *= fct
        f += 2 * tree_elems(ulayer) * pos
    head = p["head"]
    f += 2 * tree_elems(head["conv_pre"]) * pos
    for i, rate in enumerate(h.upsample_rates):
        pos *= rate
        f += 2 * tree_elems(head["ups"][i]) * pos
        f += 2 * tree_elems(head["resblocks"][i]) * pos
    f += 2 * tree_elems(head["conv_post"]) * pos
    return {"flops": f, "weight_bytes": w_bytes, "state_bytes": state_bytes}


# ---------------------------------------------------------------------------
# the whole chunk
# ---------------------------------------------------------------------------


def stage_table(cfg, tok_params, arvc_params, voc_params, fstate=None) -> Dict:
    """All four stages; pass a live `FusedState` for the exact state
    traffic."""
    tok_state = fstate.tok if fstate is not None else None
    dec_state = fstate.lm.decode if fstate is not None else None
    voc_state = fstate.voc if fstate is not None else None
    return {
        "encode": encode_stage(cfg, tok_params, tok_state),
        "lm_slow": slow_stage(cfg, arvc_params, dec_state),
        "lm_fast": fast_stage(cfg, arvc_params),
        "vocode": vocode_stage(cfg, voc_params, voc_state),
    }


def chunk_roofline(cfg, tok_params, arvc_params, voc_params, fstate=None,
                   compute_s: Optional[float] = None, peaks: Optional[Dict] = None) -> Dict:
    """Totals for one streaming chunk and the achieved utilization.

    compute_s: measured device-synchronized seconds a chunk.  peaks:
    `device_peaks()` or None."""
    stages = stage_table(cfg, tok_params, arvc_params, voc_params, fstate)
    total_flops = sum(s["flops"] for s in stages.values())
    total_bytes = sum(s["weight_bytes"] + s["state_bytes"] for s in stages.values())
    out = {
        "model": "static per-chunk FLOPs/device-memory bytes (weights and state exact "
                 "from the live tensors, FLOPs modelled; activations excluded)",
        "chunk_flops": int(total_flops),
        "chunk_hbm_bytes": int(total_bytes),
        "arithmetic_intensity": round(total_flops / max(total_bytes, 1), 3),
        "stages": {
            k: {"flops": int(s["flops"]),
                "hbm_bytes": int(s["weight_bytes"] + s["state_bytes"])}
            for k, s in stages.items()
        },
    }
    if compute_s:
        out["measured_compute_ms"] = round(compute_s * 1e3, 3)
        out["achieved_gbps"] = round(total_bytes / compute_s / 1e9, 1)
        out["achieved_tflops"] = round(total_flops / compute_s / 1e12, 3)
    if peaks:
        out["device_kind"] = peaks["device_kind"]
        ridge = peaks["bf16_flops"] / peaks["hbm_bytes_s"]
        out["ridge_flops_per_byte"] = round(ridge, 1)
        out["bound"] = ("hbm-bandwidth" if out["arithmetic_intensity"] < ridge
                        else "compute")
        out["bw_floor_ms"] = round(total_bytes / peaks["hbm_bytes_s"] * 1e3, 3)
        if compute_s:
            out["pct_peak_bw"] = round(
                100.0 * total_bytes / compute_s / peaks["hbm_bytes_s"], 1)
            out["mfu_pct"] = round(100.0 * total_flops / compute_s / peaks["bf16_flops"], 2)
        out["stage_bw_floor_ms"] = {
            k: round((s["weight_bytes"] + s["state_bytes"]) / peaks["hbm_bytes_s"] * 1e3, 3)
            for k, s in stages.items()
        }
    return out


def format_report(rf: Dict) -> str:
    """A readable block of `chunk_roofline`'s numbers."""
    lines = [
        f"roofline: {rf['chunk_flops']/1e9:.2f} GFLOP, "
        f"{rf['chunk_hbm_bytes']/1e6:.1f} MB device memory per chunk "
        f"(AI {rf['arithmetic_intensity']:.2f} flop/B"
        + (f", ridge {rf['ridge_flops_per_byte']:.0f} -> {rf['bound']}-bound"
           if "ridge_flops_per_byte" in rf else "") + ")"
    ]
    for k, s in rf["stages"].items():
        fl = rf.get("stage_bw_floor_ms", {}).get(k)
        lines.append(
            f"  {k:8s} {s['flops']/1e9:7.2f} GFLOP {s['hbm_bytes']/1e6:8.1f} MB"
            + (f"  bw-floor {fl:6.3f} ms" if fl is not None else ""))
    if "measured_compute_ms" in rf:
        lines.append(
            f"  measured {rf['measured_compute_ms']:.3f} ms/chunk -> "
            f"{rf.get('achieved_gbps', 0):.0f} GB/s"
            + (f" = {rf['pct_peak_bw']:.0f}% of peak BW, MFU {rf['mfu_pct']:.2f}%"
               if "pct_peak_bw" in rf else ""))
        if "bw_floor_ms" in rf:
            lines.append(
                f"  bandwidth floor {rf['bw_floor_ms']:.3f} ms/chunk "
                f"(measured/floor = "
                f"{rf['measured_compute_ms']/max(rf['bw_floor_ms'],1e-9):.2f}x)")
    return "\n".join(lines)
