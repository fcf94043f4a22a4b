"""Seeded random weights at a configuration's widths, drawn on the card.

The trees are in the port's layouts (conv (out, in/groups, k), transposed
conv (in, out, k), 2-D conv (out, in, kh, kw), linear (in, out), layer
stacks with a leading (L,) axis), so the benchmark hands them to the port's
`params.Converter` as they are, and the same tensors to the plain reference.
The shapes and the scales of the draws follow the published models' trees
(normal with std 0.02 for matrices and embeddings, std sqrt(2 / fan_in) for
the speaker side's convs, unit norms, zero biases, LayerScale constants);
the biases of the LM's `context_in` and `style_in` are drawn uniform in
+-1/sqrt(fan_in), as `torch.nn.Linear` draws them, because a random speaker
encoder gives all-zero timbre rows that, with zero biases, enter the LM as
exact-zero leading rows (whose float32 gradient overflows in training).

Every normal leaf of a tree comes out of one `torch.randn` call on the card
and every uniform leaf out of one `torch.rand` call, from a generator seeded
with the seed: the same seed gives the same weights, and set-up pays a few
large launches, not one per leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


class Leaf:
    """A leaf to draw: `kind` normal (std), uniform (+-bound), ones, zeros or full (value)."""

    def __init__(self, shape, kind: str, scale: float = 0.0):
        self.shape = tuple(int(s) for s in shape)
        self.kind = kind
        self.scale = float(scale)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def n(*shape, std: float = 0.02) -> Leaf:
    return Leaf(shape, "normal", std)


def ones(*shape) -> Leaf:
    return Leaf(shape, "ones")


def zeros(*shape) -> Leaf:
    return Leaf(shape, "zeros")


def full(value: float, *shape) -> Leaf:
    return Leaf(shape, "full", value)


def uniform(bound: float, *shape) -> Leaf:
    return Leaf(shape, "uniform", bound)


def he(*jax_shape) -> float:
    """The std sqrt(2 / fan_in) of a conv whose channels-last shape is `jax_shape`."""
    fan_in = math.prod(jax_shape[:-1]) if len(jax_shape) > 1 else jax_shape[0]
    return math.sqrt(2.0 / fan_in)


def conv(k: int, cin: int, cout: int, std: float = 0.02, bias: bool = True) -> Dict:
    p = {"w": n(cout, cin, k, std=std)}
    if bias:
        p["b"] = zeros(cout)
    return p


def tconv(k: int, cin: int, cout: int) -> Dict:
    return {"w": n(cin, cout, k), "b": zeros(cout)}


def linear(cin: int, cout: int, bias: bool = True) -> Dict:
    p = {"w": n(cin, cout)}
    if bias:
        p["b"] = zeros(cout)
    return p


def norm(dim: int) -> Dict:
    return {"w": ones(dim), "b": zeros(dim)}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def convnext_block(dim: int, k: int = 7, mlp: float = 4.0) -> Dict:
    h = int(mlp * dim)
    return {"dwconv": conv(k, 1, dim), "norm": norm(dim), "pwconv1": linear(dim, h),
            "pwconv2": linear(h, dim), "gamma": full(1e-6, dim)}


def convnext_encoder(c: Dict) -> Dict:
    dims, depths = c["dims"], c["depths"]
    p = {"stem_conv": conv(7, c["input_channels"], dims[0]), "stem_norm": norm(dims[0]),
         "final_norm": norm(dims[-1])}
    for i in range(len(depths) - 1):
        p[f"mid_norm_{i}"] = norm(dims[i])
        p[f"mid_conv_{i}"] = linear(dims[i], dims[i + 1])
    for i, depth in enumerate(depths):
        p[f"stage_{i}"] = [convnext_block(dims[i], c["kernel_size"]) for _ in range(depth)]
    if c["gin_channels"] > 0:
        p["g_in"] = linear(c["gin_channels"], c["input_channels"])
    return p


def windowed_transformer(t: Dict) -> Dict:
    L, d, kv, f = t["n_layer"], t["dim"], t["n_head"] * t["head_dim"], t["intermediate_size"]
    return {"layers": {
        "wqkv": {"w": n(L, d, 3 * kv)}, "wo": {"w": n(L, kv, d)},
        "attention_norm": {"w": ones(L, d)}, "ffn_norm": {"w": ones(L, d)},
        "w1": {"w": n(L, d, f)}, "w3": {"w": n(L, d, f)}, "w2": {"w": n(L, f, d)},
        "attn_scale": full(1e-2, L, d), "ffn_scale": full(1e-2, L, d)},
        "final_norm": {"w": ones(d)}}


def tokenizer(c: Dict) -> Dict:
    dims = c["quantizer"]["input_dim"]
    bits = int(round(math.log2(c["quantizer"]["codebook_size"])))
    return {
        "backbone": convnext_encoder(c["backbone"]),
        "downsample": [{"conv": conv(f, dims, dims), "block": convnext_block(dims)}
                       for f in c["quantizer"]["downsample_factor"]],
        "pre_module": windowed_transformer(c["transformer"]),
        "lfq": {"project_in": linear(dims, bits), "project_out": linear(bits, dims)},
    }


def hifigan(h: Dict) -> Dict:
    ch = h["upsample_initial_channel"]
    head = {"conv_pre": conv(h["pre_conv_kernel_size"], h["num_mels"], ch), "ups": [],
            "resblocks": []}
    for i, k in enumerate(h["upsample_kernel_sizes"]):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        head["ups"].append(tconv(k, cin, cout))
        head["resblocks"].append([
            {"convs1": [conv(rk, cout, cout) for _ in rd],
             "convs2": [conv(rk, cout, cout) for _ in rd]}
            for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])])
    head["conv_post"] = conv(h["post_conv_kernel_size"], ch // 2 ** len(h["upsample_rates"]), 1)
    return head


def vocoder(c: Dict) -> Dict:
    q = c["quantizer"]
    dims = q["input_dim"]
    per = dims // q["n_groups"]
    return {
        "backbone": convnext_encoder(c["backbone"]),
        "downsample": [{"conv": conv(f, dims, dims), "block": convnext_block(dims)}
                       for f in q["downsample_factor"]],
        "upsample": [{"conv": tconv(f, dims, dims), "block": convnext_block(dims)}
                     for f in q["downsample_factor"]],
        "fsq": {f"group_{g}": {"project_in": linear(per, len(q["levels"])),
                               "project_out": linear(len(q["levels"]), per)}
                for g in range(q["n_groups"])},
        "head": hifigan(c["head"]),
    }


def _blocks(L, dim, n_head, n_local, head_dim, inter) -> Dict:
    total = (n_head + 2 * n_local) * head_dim
    return {"wqkv": {"w": n(L, dim, total)}, "wo": {"w": n(L, n_head * head_dim, dim)},
            "attention_norm": {"w": ones(L, dim)}, "ffn_norm": {"w": ones(L, dim)},
            "w1": {"w": n(L, dim, inter)}, "w3": {"w": n(L, dim, inter)},
            "w2": {"w": n(L, inter, dim)}}


def arvc(c: Dict) -> Dict:
    d = c["decoder"]
    nl = d["n_local_heads"] if d["n_local_heads"] > 0 else d["n_head"]
    fnl = d["fast_n_local_heads"] if d["fast_n_local_heads"] > 0 else d["fast_n_head"]
    model = {
        "embeddings": n(d["vocab_size"], d["dim"]),
        "codebook_embeddings": n(d["codebook_size"] * d["num_codebooks"], d["dim"]),
        "layers": _blocks(d["n_layer"], d["dim"], d["n_head"], nl, d["head_dim"],
                          d["intermediate_size"]),
        "norm": {"w": ones(d["dim"])},
        "fast_embeddings": n(d["codebook_size"], d["fast_dim"]),
        "fast_layers": _blocks(d["n_fast_layer"], d["fast_dim"], d["fast_n_head"], fnl,
                               d["fast_head_dim"], d["fast_intermediate_size"]),
        "fast_norm": {"w": ones(d["fast_dim"])},
        "fast_output": {"w": n(d["fast_dim"], d["codebook_size"])},
    }
    if not d["tie_word_embeddings"]:
        model["output"] = {"w": n(d["dim"], d["vocab_size"])}
    return {
        "embedding": n(d["vocab_size"], d["dim"]),
        "context_in": {"w": n(c["context_dim"], d["dim"]),
                       "b": uniform(c["context_dim"] ** -0.5, d["dim"])},
        "style_in": {"w": n(c["style_dim"], d["dim"]),
                     "b": uniform(c["style_dim"] ** -0.5, d["dim"])},
        "model": model,
        "wait4start": n(8, d["dim"]),
        "wait4end": n(8, d["dim"]),
    }


def _bn(c: int, affine: bool = True) -> Dict:
    p = {"mean": zeros(c), "var": ones(c)}
    if affine:
        p.update(w=ones(c), b=zeros(c))
    return p


def _conv2d(kh, kw, cin, cout) -> Leaf:
    return n(cout, cin, kh, kw, std=he(kh, kw, cin, cout))


def _conv1d(k, cin, cout) -> Leaf:
    return n(cout, cin, k, std=he(k, cin, cout))


def campplus(c: Dict) -> Dict:
    def res_block(cin, cout, stride):
        p = {"conv1": _conv2d(3, 3, cin, cout), "bn1": _bn(cout),
             "conv2": _conv2d(3, 3, cout, cout), "bn2": _bn(cout)}
        if stride != 1 or cin != cout:
            p["shortcut_conv"] = _conv2d(1, 1, cin, cout)
            p["shortcut_bn"] = _bn(cout)
        return p

    m = 32
    fcm = {"conv1": _conv2d(3, 3, 1, m), "bn1": _bn(m), "conv2": _conv2d(3, 3, m, m),
           "bn2": _bn(m), "layer1": [res_block(m, m, 2), res_block(m, m, 1)],
           "layer2": [res_block(m, m, 2), res_block(m, m, 1)]}
    ch = m * (c["feat_dim"] // 8)
    p = {"fcm": fcm, "tdnn_conv": _conv1d(5, ch, c["init_channels"]),
         "tdnn_bn": _bn(c["init_channels"])}
    ch = c["init_channels"]
    g = c["growth_rate"]
    for bi, (n_layers, k) in enumerate(zip(c["block_layers"], c["block_kernels"])):
        layers = []
        for li in range(n_layers):
            cin = ch + li * g
            bnc = c["bn_size"] * g
            layers.append({
                "nl1": _bn(cin), "lin1_w": _conv1d(1, cin, bnc), "nl2": _bn(bnc),
                "cam": {"local_w": _conv1d(k, bnc, g),
                        "fc1_w": n(bnc, bnc // 2, std=he(bnc, bnc // 2)),
                        "fc1_b": zeros(bnc // 2),
                        "fc2_w": n(bnc // 2, g, std=he(bnc // 2, g)), "fc2_b": zeros(g)}})
        p[f"block{bi + 1}"] = layers
        ch = ch + n_layers * g
        p[f"transit{bi + 1}"] = {"bn": _bn(ch), "w": _conv1d(1, ch, ch // 2)}
        ch //= 2
    p["out_bn"] = _bn(ch)
    p["dense_w"] = _conv1d(1, ch * 2, c["embedding_size"])
    p["dense_bn"] = _bn(c["embedding_size"], affine=False)
    return p


def speaker(c: Dict) -> Dict:
    C = c["ecapa_channels"]

    def res2():
        w = C // 8
        return {"conv1_w": conv(1, C, C)["w"], "conv1_b": zeros(C), "bn1": _bn(C),
                "conv2_w": conv(1, C, C)["w"], "conv2_b": zeros(C), "bn2": _bn(C),
                "se1_w": n(C, 128), "se1_b": zeros(128), "se2_w": n(128, C), "se2_b": zeros(C),
                "res2": [{"w": conv(3, w, w)["w"], "b": zeros(w), "bn": _bn(w)}
                         for _ in range(7)]}

    ecapa = {"layer1_w": conv(5, c["input_dim"], C)["w"], "layer1_b": zeros(C),
             "layer1_bn": _bn(C), "layer2": res2(), "layer3": res2(), "layer4": res2(),
             "conv_w": conv(1, 3 * C, 1536)["w"], "conv_b": zeros(1536)}
    d = c["latent_dim"]
    inner = int(d * 4 * 2 / 3)
    layers = [{"to_q": n(d, 512), "to_kv": n(d, 1024), "to_out": n(512, d),
               "ff1_w": n(d, inner * 2), "ff1_b": zeros(inner * 2), "ff2_w": n(inner, d),
               "ff2_b": zeros(d)} for _ in range(2)]
    perceiver = {"proj_w": n(1536, d), "proj_b": zeros(d), "latents": n(c["token_num"], d),
                 "layers": layers, "norm": {"gamma": ones(d)}}
    fsq = {"project_in": linear(d, len(c["fsq_levels"])),
           "project_out": linear(len(c["fsq_levels"]), d)}
    return {"ecapa": ecapa, "perceiver": perceiver, "fsq": fsq}


SPECS = {"tokenizer": tokenizer, "vocoder": vocoder, "arvc": arvc, "campplus": campplus,
         "speaker": speaker}


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------


def _leaves(tree, out: List[Leaf]) -> List[Leaf]:
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _fill(tree, made: Dict[int, torch.Tensor]):
    if isinstance(tree, Leaf):
        return made[id(tree)]
    if isinstance(tree, dict):
        return {k: _fill(v, made) for k, v in tree.items()}
    return [_fill(v, made) for v in tree]


def draw(specs: Dict[str, Dict], seed: int, device, dtypes: Dict[str, torch.dtype]
         ) -> Dict[str, Dict]:
    """Every tree of `specs` (name -> tree of Leaf) drawn on `device` from
    `seed`: one randn and one rand call for all of them, float32, then each
    tree cast to its dtype in `dtypes` (float32 where not named)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    leaves = [leaf for name in specs for leaf in _leaves(specs[name], [])]
    normal = [lf for lf in leaves if lf.kind == "normal"]
    unif = [lf for lf in leaves if lf.kind == "uniform"]
    made: Dict[int, torch.Tensor] = {}
    for group, fn in ((normal, torch.randn), (unif, torch.rand)):
        if not group:
            continue
        flat = fn(sum(lf.numel for lf in group), generator=gen, device=device)
        off = 0
        for lf in group:
            t = flat[off:off + lf.numel].view(lf.shape)
            made[id(lf)] = t * lf.scale if lf.kind == "normal" else (2.0 * t - 1.0) * lf.scale
            off += lf.numel
    for lf in leaves:
        if lf.kind == "ones":
            made[id(lf)] = torch.ones(lf.shape, device=device)
        elif lf.kind == "zeros":
            made[id(lf)] = torch.zeros(lf.shape, device=device)
        elif lf.kind == "full":
            made[id(lf)] = torch.full(lf.shape, lf.scale, device=device)
    out = {}
    for name, spec in specs.items():
        dt = dtypes.get(name, torch.float32)
        out[name] = cast(_fill(spec, made), dt)
    return out


def cast(tree, dtype):
    """Every floating tensor of a tree in `dtype` (contiguous copies)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype).contiguous()


def count(tree) -> int:
    """Parameters of a tree of Leaf or of tensors."""
    if isinstance(tree, Leaf):
        return tree.numel
    if torch.is_tensor(tree):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    return sum(count(v) for v in tree)
