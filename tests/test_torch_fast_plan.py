"""The fast loop's work plan, and a model of its persistent kernel, on the CPU.

`work_plan` (ops/fast_decode.py) gives every block of the one cooperative
launch its columns of each phase; csrc/fast_decode.cu reads it as is.  The
plan is checked at the published geometry (4 x 768, 12 x 64, inter 2304,
vocab 1000, 8 codebooks, 132 blocks) in both weight types and at two tiny
ones.  Then `_model_loop` runs the loop phase by phase as the kernel does:
each block computes only its own columns over the whole K, reads what other
blocks wrote only from a snapshot taken at the last grid barrier (as the
barriers guarantee, no more), every block runs the attention and the sampler
itself, and the next step's input comes from the embedding table.  Held to
`fast_decode_plain` in float32: codes equal, the audio embedding within
1e-5 (column slices sum in another order than the whole matmul).
"""

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.config import DualARConfig
from streamvoiceanon_tpu_torch.ops import fast_decode as fd
from streamvoiceanon_tpu_torch.ops.decode_common import dot, freqs_table, nucleus_sample
from streamvoiceanon_tpu_torch.ops.norm import rms_norm
from streamvoiceanon_tpu_torch.utils import randparams as rp


# (L, dim, n_head, head_dim, inter, V, nq, blocks, dtype)
GEOMETRIES = {
    "published_bf16": (4, 768, 12, 64, 2304, 1000, 8, 132, torch.bfloat16),
    "published_f32": (4, 768, 12, 64, 2304, 1000, 8, 132, torch.float32),
    "tiny_f32": (2, 64, 4, 16, 128, 40, 4, 7, torch.float32),
    "tiny_bf16": (3, 32, 2, 16, 96, 24, 3, 5, torch.bfloat16),
}


def _plan(geo):
    L, dim, _, _, inter, V, _, G, dt = GEOMETRIES[geo]
    return fd.work_plan(L, dim, inter, V, G, dt)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_every_column_of_every_phase_is_owned_once(geo):
    L, dim, _, _, inter, V, _, G, dt = GEOMETRIES[geo]
    plan = _plan(geo)
    assert plan.shape == (G, len(fd.PHASES), 2) and plan.dtype == np.int32
    for p, n_units in enumerate(fd.phase_units(dim, inter, V, dt)):
        owned = np.zeros(n_units, dtype=int)
        for first, n in plan[:, p]:
            assert n >= 0 and 0 <= first and first + n <= n_units
            owned[first : first + n] += 1
        assert (owned == 1).all(), fd.PHASES[p]


def _owner(plan, p, n_cols, u):
    """Block that owns each output column of phase p."""
    own = np.full(n_cols, -1)
    for b, (first, n) in enumerate(plan[:, p]):
        own[first * u : (first + n) * u] = b
    return own


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_rope_pairs_and_swiglu_columns_share_a_block(geo):
    L, dim, H, hd, inter, V, _, G, dt = GEOMETRIES[geo]
    plan, u = _plan(geo), fd.unit_cols(dt)
    qkv = _owner(plan, fd.PHASES.index("qkv"), 3 * dim, u)
    assert (qkv[0 : 2 * dim : 2] == qkv[1 : 2 * dim : 2]).all()  # q and k pairs
    # one run of units a block serves both w1 and w3: column c of each
    w13 = _owner(plan, fd.PHASES.index("w13"), inter, u)
    assert (w13 >= 0).all() and u % 2 == 0 and hd % 2 == 0


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_resident_weights_and_the_ring_fit_a_block(geo):
    """Every block's resident slices plus the ring and the fixed buffers fit
    in 227 KB; no slice keeps more tasks than it has; at the published bf16
    geometry every streamed slice fits the ring (nothing is read from global
    memory inside a phase) and about 40 % of the weights stay on chip."""
    L, dim, _, hd, inter, V, nq, G, dt = GEOMETRIES[geo]
    res = fd.resident_plan(L, dim, inter, V, G, dt, nq, hd)
    assert res.shape == (G, 4 * L + 1) and res.dtype == np.int32
    per_block = fd.resident_bytes(res, L, dim, inter)
    assert fd.smem_bytes(dim, inter, V, nq, hd) + per_block.max() <= fd.MAX_SMEM
    counts = _plan(geo)[:, :, 1]
    shapes = fd.slice_shapes(L, dim, inter)
    tasks = np.stack([counts[:, p] * nmat for p, nmat, _ in shapes], axis=1)
    assert (0 <= res).all() and (res <= tasks).all()
    streamed = (tasks - res) * np.asarray([tb for _, _, tb in shapes])
    if geo == "published_bf16":
        assert (streamed <= fd.RING_BYTES).all()
        share = per_block.sum() / (per_block.sum() + streamed.sum())
        assert 0.3 < share < 0.5


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_largest_share_within_one_and_a_half_of_the_mean(geo):
    L, dim, _, _, inter, V, _, G, dt = GEOMETRIES[geo]
    plan = _plan(geo)
    per_block = plan[:, :, 1] @ np.asarray(fd.unit_bytes(L, dim, inter))
    assert per_block.sum() == sum(n * b for n, b in zip(
        fd.phase_units(dim, inter, V, dt), fd.unit_bytes(L, dim, inter)))
    assert per_block.max() <= 1.5 * per_block.mean()


def test_packed_layout_and_its_cache():
    w = torch.arange(2 * 6 * 16, dtype=torch.float32).reshape(2, 6, 16)
    p = fd.packed(w)
    assert p.shape == (2, 4, 6, 4)
    for u in range(4):
        assert torch.equal(p[:, u], w[:, :, 4 * u : 4 * u + 4])
    assert fd.packed(w) is p  # kept
    w.add_(1.0)  # an in-place update packs again
    p2 = fd.packed(w)
    assert p2 is not p and torch.equal(p2[:, 1], w[:, :, 4:8])
    assert fd.packed(w.bfloat16()).shape == (2, 2, 6, 8)


def _model_loop(p, hidden, gumbel, *, nq, n_head, head_dim, n_blocks, greedy,
                temperature=0.7, top_p=0.7, norm_eps=1e-5, rope_base=10000.0):
    """The kernel's data flow in plain PyTorch (float32): returns (codes
    (1, nq), audio_emb (1, mdim))."""
    lay = p["fast_layers"]
    wd = p["fast_output"]["w"].dtype
    L, dim, _ = lay["wqkv"]["w"].shape
    inter, V = lay["w1"]["w"].shape[-1], p["fast_output"]["w"].shape[-1]
    H, hd, G = n_head, head_dim, n_blocks
    plan = fd.work_plan(L, dim, inter, V, G, wd)
    u = fd.unit_cols(wd)
    fr = freqs_table(nq, hd, rope_base, hidden.device)
    live = {"h": hidden.reshape(dim).to(wd).clone(), "q": torch.zeros(dim),
            "kc": torch.zeros((L, nq, dim), dtype=wd), "vc": torch.zeros((L, nq, dim), dtype=wd),
            "gate": torch.zeros(inter, dtype=wd), "logits": torch.zeros((nq, V))}
    written = {}

    def barrier():
        for key, count in written.items():  # every output column once a phase
            assert (count == 1).all(), key
        written.clear()
        return {k: v.clone() for k, v in live.items()}

    def mark(key, idx, n):
        written.setdefault(key, torch.zeros(n, dtype=torch.int32))[idx] += 1

    def cols(b, phase):
        first, n = plan[b, fd.PHASES.index(phase)]
        return torch.arange(first * u, (first + n) * u)

    def rope(vals, c, s):  # vals at even-aligned columns c (pairs whole)
        d = c % hd
        cs, sn = fr[s, d // 2, 0], fr[s, d // 2, 1]
        x0, x1 = vals[0::2].repeat_interleave(2), vals[1::2].repeat_interleave(2)
        return torch.where(d % 2 == 0, x0 * cs - x1 * sn, x1 * cs + x0 * sn)

    snap = barrier()
    codes, aemb, code = [], None, [None] * G
    for s in range(nq):
        for l in range(L):
            for b in range(G):  # A
                c = cols(b, "qkv")
                if not len(c):
                    continue
                x = p["fast_embeddings"][code[b]][0] if l == 0 and s > 0 else snap["h"]
                xn = rms_norm(x[None], lay["attention_norm"]["w"][l], norm_eps)
                y = dot(xn, lay["wqkv"]["w"][l][:, c])[0].float()
                qm, km, vm = c < dim, (c >= dim) & (c < 2 * dim), c >= 2 * dim
                live["q"][c[qm]] = rope(y[qm], c[qm], s)
                live["kc"][l, s, c[km] - dim] = rope(y[km], c[km] - dim, s).to(wd)
                live["vc"][l, s, c[vm] - 2 * dim] = y[vm].to(wd)
                mark("qkv", c, 3 * dim)
            snap = barrier()
            for b in range(G):  # B: every block's own attention, then wo
                c = cols(b, "wo")
                if not len(c):
                    continue
                q = snap["q"].reshape(H, hd)
                k = snap["kc"][l, : s + 1].float().reshape(s + 1, H, hd)
                v = snap["vc"][l, : s + 1].float().reshape(s + 1, H, hd)
                w = torch.softmax((q * k).sum(-1) / np.sqrt(hd), dim=0)
                attn = (w[..., None] * v).sum(0).reshape(1, dim).to(wd)
                live["h"][c] = snap["h"][c] + dot(attn, lay["wo"]["w"][l][:, c])[0]
                mark("wo", c, dim)
            snap = barrier()
            for b in range(G):  # C
                c = cols(b, "w13")
                if not len(c):
                    continue
                fn = rms_norm(snap["h"][None], lay["ffn_norm"]["w"][l], norm_eps)
                a = dot(fn, lay["w1"]["w"][l][:, c]).float()
                g = (a / (1.0 + torch.exp(-a))).to(wd) * dot(fn, lay["w3"]["w"][l][:, c])
                live["gate"][c] = g[0]
                mark("w13", c, inter)
            snap = barrier()
            for b in range(G):  # D
                c = cols(b, "w2")
                if len(c):
                    live["h"][c] = snap["h"][c] + dot(snap["gate"][None],
                                                      lay["w2"]["w"][l][:, c])[0]
                    mark("w2", c, dim)
            snap = barrier()
        for b in range(G):  # head
            c = cols(b, "head")
            if len(c):
                hn = rms_norm(snap["h"][None], p["fast_norm"]["w"].to(wd), norm_eps)
                live["logits"][s, c] = dot(hn, p["fast_output"]["w"][:, c])[0].float()
                mark("head", c, V)
        snap = barrier()
        g = None if greedy else gumbel.reshape(nq, V)[s]
        for b in range(G):  # every block samples; h's wo owners take the embedding
            code[b] = nucleus_sample(snap["logits"][s], g, greedy=greedy,
                                     temperature=temperature, top_p=top_p)
            c = cols(b, "wo")
            live["h"][c] = p["fast_embeddings"][code[b]][0][c].to(wd)
        assert all(torch.equal(cb, code[0]) for cb in code)
        codes.append(code[0])
        contrib = p["codebook_embeddings"][s * V + code[0]].to(wd)
        aemb = contrib if s == 0 else aemb + contrib
    return torch.cat(codes).reshape(1, nq), aemb


TINY = DualARConfig(vocab_size=64, n_layer=1, n_head=2, dim=32, intermediate_size=64,
                    head_dim=16, max_seq_len=16, codebook_size=40, num_codebooks=4,
                    n_fast_layer=2, fast_dim=64, fast_n_head=4, fast_head_dim=16,
                    fast_intermediate_size=128)


@pytest.mark.parametrize("n_blocks", [3, 7, 132])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_model_of_the_kernel_matches_the_plain_loop(n_blocks, greedy):
    """Two fast layers of 64 (4 heads x 16, inter 128), vocab 40, 4
    codebooks; three frames each, with numpy Gumbel noise when sampled."""
    p = P.dual_ar_params(rp.dual_ar_params_np(TINY, seed=3), "cpu")
    rng = np.random.default_rng(n_blocks)
    kw = dict(nq=4, n_head=4, head_dim=16)
    for _ in range(3):
        hidden = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
        u = rng.uniform(1e-6, 1.0, (1, 4, 40))
        gumbel = torch.from_numpy(-np.log(-np.log(u)).astype(np.float32))
        args = (p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
                p["fast_embeddings"], p["codebook_embeddings"], hidden, gumbel)
        want_codes, want_aemb = fd.fast_decode_plain(*args, greedy=greedy, **kw)
        codes, aemb = _model_loop(p, hidden, gumbel, n_blocks=n_blocks, greedy=greedy, **kw)
        assert torch.equal(codes, want_codes)
        np.testing.assert_allclose(aemb.numpy(), want_aemb.numpy(), atol=1e-5, rtol=0)
