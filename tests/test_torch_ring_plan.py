"""The ring step's plan, and a model of its persistent kernel, on the CPU.

`work_plan`, `attention_splits` and `attention_items` (ops/wt_stream.py)
give every block of the one cooperative launch its columns of each matvec
phase and its attention items; csrc/wt_stream.cu reads the plan as is and
deals the items by the same rule.  The plan is checked at the published
geometry (8 x 512, 8 x 64, inter 1536, W 512, 132 blocks) in both weight
types and at two tiny ones.  Then `_model_step` runs a call phase by phase
as the kernel does: each block computes only its own columns over the
whole K and its own items, reads what other blocks wrote only from a
snapshot taken at the last grid barrier (as the barriers guarantee, no
more), never reads a stale ring row (they are NaN in a second run of the
model), and merges the items of each head in split order, the fresh row
last.  Held to `wt_stream_step_plain` in float32 within 1e-5 (column slices
and split sums add in another order than the whole products) on the output
row and both whole rings.
"""

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch.ops import wt_stream as wts
from streamvoiceanon_tpu_torch.ops.decode_common import MAX_SMEM, dot, unit_cols
from streamvoiceanon_tpu_torch.ops.norm import rms_norm

# (L, dim, n_head, head_dim, inter, W, blocks, dtype)
GEOMETRIES = {
    "published_f32": (8, 512, 8, 64, 1536, 512, 132, torch.float32),
    "published_bf16": (8, 512, 8, 64, 1536, 512, 132, torch.bfloat16),
    "tiny_f32": (3, 32, 2, 16, 64, 8, 5, torch.float32),
    "small_bf16": (2, 48, 3, 16, 96, 40, 7, torch.bfloat16),
}


def _plan(geo):
    _, dim, _, _, inter, _, G, dt = GEOMETRIES[geo]
    return wts.work_plan(dim, inter, G, dt)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_every_column_of_every_phase_is_owned_once(geo):
    _, dim, _, _, inter, _, G, dt = GEOMETRIES[geo]
    plan = _plan(geo)
    assert plan.shape == (G, len(wts.PHASES), 2) and plan.dtype == np.int32
    for p, n_units in enumerate(wts.phase_units(dim, inter, dt)):
        owned = np.zeros(n_units, dtype=int)
        for first, n in plan[:, p]:
            assert n >= 0 and 0 <= first and first + n <= n_units
            owned[first : first + n] += 1
        assert (owned == 1).all(), wts.PHASES[p]
        # no block waits on more than its share of a phase
        assert plan[:, p, 1].max() == -(-n_units // G)


def _owner(plan, p, n_cols, u):
    own = np.full(n_cols, -1)
    for b, (first, n) in enumerate(plan[:, p]):
        own[first * u : (first + n) * u] = b
    return own


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_rope_pairs_and_swiglu_columns_share_a_block(geo):
    _, dim, _, hd, inter, _, _, dt = GEOMETRIES[geo]
    plan, u = _plan(geo), unit_cols(dt)
    qkv = _owner(plan, wts.PHASES.index("qkv"), 3 * dim, u)
    assert (qkv[0 : 2 * dim : 2] == qkv[1 : 2 * dim : 2]).all()  # q and k pairs
    # a w13 unit is a w1 and a w3 slice of the same columns: one owner each
    w13 = _owner(plan, wts.PHASES.index("w13"), inter, u)
    assert (w13 >= 0).all() and u % 2 == 0 and hd % 2 == 0


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_attention_items_cover_every_slot_once_in_split_order(geo):
    _, _, H, _, _, W, G, _ = GEOMETRIES[geo]
    n_split, span = wts.attention_splits(W)
    assert n_split <= wts.MAX_SPLITS and (n_split - 1) * span < W <= n_split * span
    items = wts.attention_items(H, W, G)
    seen = np.zeros((H, W), dtype=int)
    for b, its in enumerate(items):
        for k, (head, split) in enumerate(its):
            assert head * n_split + split == b + k * G  # round robin, in item order
            seen[head, split * span : min(W, (split + 1) * span)] += 1
    assert (seen == 1).all()
    if geo.startswith("published"):
        assert (H, n_split, span) == (8, 16, 32)
        assert all(len(its) == (b < 128) for b, its in enumerate(items))


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_a_block_fits_in_shared_memory(geo):
    L, dim, H, hd, inter, W, _, dt = GEOMETRIES[geo]
    wts.check_geometry(L, dim, H, hd, inter, W, dt)
    assert wts.smem_bytes(dim, inter, H, hd, W) <= MAX_SMEM
    assert wts.part_stride(hd) % 4 == 0 and wts.part_stride(hd) >= hd + wts.PART


def test_published_geometry_has_40_phases():
    assert len(wts.phases(8)) == 40
    assert wts.phases(8)[:6] == [(0, "A"), (0, "B"), (0, "C"), (0, "D"), (0, "E"), (1, "A")]


def _model_step(layers, x1, k_ring, v_ring, count, *, n_head, head_dim, n_blocks,
                table_rows, order, norm_eps=1e-5, rope_base=10000.0):
    """The kernel's data flow in plain PyTorch (float32): returns (h (1,
    dim), k_ring, v_ring), the rings written in place at the current slot."""
    lay = layers
    wd = lay["wqkv"]["w"].dtype
    L, dim, _ = lay["wqkv"]["w"].shape
    inter, W = lay["w1"]["w"].shape[-1], k_ring.shape[1]
    H, hd, G = n_head, head_dim, n_blocks
    plan, u = wts.work_plan(dim, inter, G, wd), unit_cols(wd)
    items = wts.attention_items(H, W, G)
    n_split, span = wts.attention_splits(W)
    ps, P0 = wts.part_stride(hd), wts.PART
    cos, sin = wts.table_tensors(table_rows, hd, H, rope_base, x1.device)
    p = W + count % (table_rows - W)
    cosr, sinr = cos[p], sin[p]
    slot, nv = count % W, min(count, W)
    scale = 1.0 / np.sqrt(hd)
    nan = float("nan")
    live = {"h": torch.full((dim,), nan), "qkv": torch.full((3 * dim,), nan),
            "gate": torch.full((inter,), nan), "part": torch.full((H * n_split * ps,), nan),
            "kr": k_ring, "vr": v_ring}
    x = x1.reshape(dim).to(wd)
    written = {}

    def barrier():
        for key, cnt in written.items():  # every output once a phase
            assert (cnt == 1).all(), key
        written.clear()
        return {k: v.clone() for k, v in live.items()}

    def mark(key, idx, n):
        written.setdefault(key, torch.zeros(n, dtype=torch.int32))[idx] += 1

    def cols(b, phase):
        first, n = plan[b, wts.PHASES.index(phase)]
        return torch.arange(first * u, (first + n) * u)

    ran = []
    snap = barrier()
    for l, kind in wts.phases(L):
        ran.append((l, kind))
        for b in order(G):
            if kind == "A":
                c = cols(b, "qkv")
                if not len(c):
                    continue
                hin = x if l == 0 else snap["h"]
                xn = rms_norm(hin[None], lay["attention_norm"]["w"][l], norm_eps)
                y = dot(xn, lay["wqkv"]["w"][l][:, c])[0]
                cc = c % dim
                r = (y * cosr[cc] + wts.partner(y[None])[0] * sinr[cc]).to(wd)
                val = torch.where(c < 2 * dim, r, y)
                live["qkv"][c] = val
                km, vm = (c >= dim) & (c < 2 * dim), c >= 2 * dim
                live["kr"][l, slot, cc[km]] = val[km].to(k_ring.dtype)
                live["vr"][l, slot, cc[vm]] = val[vm].to(v_ring.dtype)
                mark("qkv", c, 3 * dim)
            elif kind == "B":
                for head, split in items[b]:
                    hs = slice(head * hd, (head + 1) * hd)
                    q = snap["qkv"][hs]
                    kn = snap["qkv"][dim:][hs]
                    j = torch.arange(split * span, min(W, (split + 1) * span))
                    j = j[(j < nv) & (j != slot)]  # never a stale row
                    s = (snap["kr"][l, j][:, hs] * q).sum(-1) * scale
                    m = s.max() if len(j) else torch.tensor(float("-inf"))
                    e = torch.exp(s - m)
                    acc = (e[:, None] * snap["vr"][l, j][:, hs]).sum(0)
                    it = head * n_split + split
                    row = torch.zeros(ps)
                    row[0], row[1], row[2] = m, e.sum(), (q * kn).sum() * scale
                    row[P0 : P0 + hd] = acc
                    live["part"][it * ps : (it + 1) * ps] = row
                    mark("part", it, H * n_split)
            elif kind == "C":
                c = cols(b, "wo")
                if not len(c):
                    continue
                part = snap["part"].reshape(H, n_split, ps)
                mi, si, sn = part[:, :, 0], part[:, :, 1], part[:, 0, 2]
                mx = torch.maximum(mi.max(1).values, sn)
                w = torch.where(mi == float("-inf"), 0.0, torch.exp(mi - mx[:, None]))
                den = torch.zeros(H)
                acc = torch.zeros(H, hd)
                for i in range(n_split):  # split order, the fresh row last
                    den = den + si[:, i] * w[:, i]
                    acc = acc + part[:, i, P0 : P0 + hd] * w[:, i, None]
                en = torch.exp(sn - mx)
                den = den + en
                acc = acc + en[:, None] * snap["qkv"][2 * dim :].reshape(H, hd)
                attn = (acc / den[:, None]).reshape(1, dim).to(wd)
                hold = (x if l == 0 else snap["h"])[c]
                y = dot(attn, lay["wo"]["w"][l][:, c])[0]
                live["h"][c] = hold + lay["attn_scale"][l][c] * y
                mark("h", c, dim)
            elif kind == "D":
                c = cols(b, "w13")
                if not len(c):
                    continue
                fn = rms_norm(snap["h"][None], lay["ffn_norm"]["w"][l], norm_eps)
                a = dot(fn, lay["w1"]["w"][l][:, c])
                g = dot(fn, lay["w3"]["w"][l][:, c])
                live["gate"][c] = ((a / (1.0 + torch.exp(-a))) * g)[0]
                mark("gate", c, inter)
            else:
                c = cols(b, "w2")
                if len(c):
                    live["h"][c] = snap["h"][c] + lay["ffn_scale"][l][c] * dot(
                        snap["gate"][None], lay["w2"]["w"][l][:, c])[0]
                    mark("h", c, dim)
        snap = barrier()
    assert ran == wts.phases(L)
    return snap["h"][None], live["kr"], live["vr"]


def _layers(L, dim, inter, seed):
    rng = np.random.default_rng(seed)
    n = lambda *sh: torch.from_numpy((rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32))
    uni = lambda lo, hi: torch.from_numpy(rng.uniform(lo, hi, (L, dim)).astype(np.float32))
    return {"wqkv": {"w": n(L, dim, 3 * dim)}, "wo": {"w": n(L, dim, dim)},
            "w1": {"w": n(L, dim, inter)}, "w3": {"w": n(L, dim, inter)},
            "w2": {"w": n(L, inter, dim)}, "attention_norm": {"w": uni(0.5, 1.5)},
            "ffn_norm": {"w": uni(0.5, 1.5)}, "attn_scale": uni(0.1, 0.5),
            "ffn_scale": uni(0.1, 0.5)}


# (L, dim, n_head, head_dim, inter, W, table_rows): R = table_rows - W tokens
# between rebases
MODEL_GEOS = {"w8": (3, 32, 2, 16, 64, 8, 20), "w40": (2, 48, 3, 16, 96, 40, 100)}
# 0, 1, W - 1, W, past W, and both sides of a rebase (R - 1, R)
MODEL_COUNTS = {"w8": (0, 1, 7, 8, 10, 11, 12, 25), "w40": (0, 1, 39, 40, 47, 59, 60)}


@pytest.mark.parametrize("n_blocks", [5, 132])
@pytest.mark.parametrize("geo", sorted(MODEL_GEOS))
def test_model_of_the_kernel_matches_the_plain_step(geo, n_blocks):
    L, dim, H, hd, inter, W, rows = MODEL_GEOS[geo]
    assert n_blocks != 5 or n_blocks < H * wts.attention_splits(W)[0]
    layers = _layers(L, dim, inter, seed=n_blocks)
    rng = np.random.default_rng(7)
    kw = dict(n_head=H, head_dim=hd, table_rows=rows)
    shuffled = lambda G: rng.permutation(G).tolist()
    for count in MODEL_COUNTS[geo]:
        x = torch.from_numpy(rng.standard_normal((1, dim)).astype(np.float32))
        kr, vr = (torch.from_numpy(rng.standard_normal((L, W, dim)).astype(np.float32))
                  for _ in range(2))
        kr = wts.maybe_rebase_ring(kr, count, head_dim=hd, n_head=H, table_rows=rows)
        want = wts.wt_stream_step_plain(layers, x, kr.clone(), vr.clone(), count, **kw)
        got = _model_step(layers, x, kr.clone(), vr.clone(), count, n_blocks=n_blocks,
                          order=shuffled, **kw)
        for a, b, what in zip(got, want, ("h", "k_ring", "v_ring")):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{what} at count {count}")
        # stale rows (not yet written, or the current slot) are never read
        stale = torch.ones(W, dtype=torch.bool)
        stale[: min(count, W)] = False
        stale[count % W] = True
        kp, vp = kr.clone(), vr.clone()
        kp[:, stale], vp[:, stale] = float("nan"), float("nan")
        h2, k2, v2 = _model_step(layers, x, kp, vp, count, n_blocks=n_blocks,
                                 order=lambda G: list(range(G)), **kw)
        np.testing.assert_allclose(h2.numpy(), got[0].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(k2[:, count % W].numpy(), got[1][:, count % W].numpy())
        np.testing.assert_array_equal(v2[:, count % W].numpy(), got[2][:, count % W].numpy())
