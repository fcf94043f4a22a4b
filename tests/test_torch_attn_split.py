"""The decode attention's split-and-merge plan, modelled on the CPU.

`csrc/decode_attention.cu` cuts each head's pos + T rows into `split_plan`'s
splits of R rows, one block each.  Inside a block, lane group g of the
block's DA_THREADS / lanes-a-row groups takes rows r0 + p * NG * DA_U +
u * NG + g (pass p, u < DA_U), both caches at once, and folds each pass into
its running max, sum and value sums; the groups merge by warp, the warps
in order, into one partial a query; the last block of a head to take its
ticket merges the partials in split order.  Rows >= pos come from the
new-row inputs, never the cache; the block whose split holds row pos
writes them into the cache.

The model below repeats that arithmetic in PyTorch (it is not part of the
package), runs the blocks in a shuffled order against kept scratch that
starts as NaN, with every cache row >= pos poisoned with NaN, and must
agree with `decode_attention_plain` (itself held against the JAX Pallas
kernel by tests/test_torch_attention.py): float32 within 1e-5 (the two
differ by summation order only); bf16 within one bf16 ulp of the larger
output plus that 1e-5 (an output near zero is a sum that cancels, where
the float32 difference can exceed its own bf16 spacing);
the cache rows written equal the new rows, and rows >= pos + T stay
untouched.
"""

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch.ops.attention import (
    DA_THREADS, DA_U, decode_attention_plain, lane_groups, max_splits, split_plan)

D, S = 64, 1024
INF = float("inf")


def rescale(m, M):
    """e^(m - M), 0 where m holds no score."""
    return torch.where(m == -INF, 0.0, torch.exp(m - torch.where(M == -INF, 0.0, M)))


def block_partial(qs, kc, vc, kn, vn, pos, r0, r1):
    """One block's partial for every head at once: (m, l) (H, T) and acc
    (H, T, D), as the kernel's lane groups, warps and block merge them."""
    H, T, _ = qs.shape
    NG = lane_groups(D, kc.dtype)
    gpw = NG // (DA_THREADS // 32)  # lane groups a warp
    m = torch.full((H, T, NG), -INF)
    l = torch.zeros(H, T, NG)
    acc = torch.zeros(H, T, NG, D)
    for base in range(r0, r1, NG * DA_U):
        j = base + torch.arange(DA_U)[:, None] * NG + torch.arange(NG)[None, :]  # (U, NG)
        valid = j < r1
        jc = j.clamp(max=r1 - 1)
        old = jc < pos
        fresh = (jc - pos).clamp(min=0, max=T - 1)
        cols = jc.clamp(max=max(pos - 1, 0))
        k = torch.where(old[..., None], kc[:, cols], kn[:, fresh]).float()  # (H, U, NG, D)
        v = torch.where(old[..., None], vc[:, cols], vn[:, fresh]).float()
        s = torch.einsum("htd,hugd->htug", qs, k)
        live = valid[None, None] & (j[None, None] <= pos + torch.arange(T)[None, :, None, None])
        s = torch.where(live, s, -INF)
        mx = torch.maximum(m, s.amax(dim=2))
        c = rescale(m, mx)
        w = torch.where(live, torch.exp(s - torch.where(mx == -INF, 0.0, mx)[:, :, None]), 0.0)
        l = torch.where(mx == -INF, l, l * c + w.sum(2))
        acc = torch.where((mx == -INF)[..., None], acc,
                          acc * c[..., None] + torch.einsum("htug,hugd->htgd", w, v))
        m = mx
    # lane groups of a warp, then the warps in order
    mw = m.reshape(H, T, -1, gpw)
    Mw = mw.amax(-1)
    cw = rescale(mw, Mw[..., None])
    lw = (l.reshape(H, T, -1, gpw) * cw).sum(-1)
    aw = (acc.reshape(H, T, -1, gpw, D) * cw[..., None]).sum(-2)
    M = Mw.amax(-1)
    cb = rescale(Mw, M[..., None])
    return M, (lw * cb).sum(-1), (aw * cb[..., None]).sum(-2)


def kernel_model(q, kn, vn, kc, vc, pos, rng):
    """The launch: blocks in a shuffled order, partials in NaN scratch, the
    last block of a head merging in split order.  Returns the output."""
    H, T, _ = q.shape
    cd = kc.dtype
    R, nsplit = split_plan(H, pos + T, D, cd)
    qs = (q.to(cd).float() / float(np.sqrt(D))).to(cd).float()
    part_m = torch.full((H, nsplit, T), float("nan"))
    part_l = torch.full((H, nsplit, T), float("nan"))
    part_a = torch.full((H, nsplit, T, D), float("nan"))
    tickets = [0] * H
    out = torch.full((H, T, D), float("nan"))
    blocks = [(h, s) for h in range(H) for s in range(nsplit)]
    rng.shuffle(blocks)
    partial = {}  # the blocks of one split compute alike for every head
    for h, s in blocks:
        r0, r1 = s * R, min(s * R + R, pos + T)
        if s not in partial:
            partial[s] = block_partial(qs, kc, vc, kn, vn, pos, r0, r1)
        if s == pos // R:
            kc[h, pos : pos + T], vc[h, pos : pos + T] = kn[h], vn[h]
        m, l, a = partial[s]
        part_m[h, s], part_l[h, s], part_a[h, s] = m[h], l[h], a[h]
        tickets[h] += 1
        if tickets[h] == nsplit:
            pm, pl, pa = part_m[h], part_l[h], part_a[h]
            assert not (torch.isnan(pm).any() or torch.isnan(pl).any()
                        or torch.isnan(pa).any())
            M = pm.amax(0)
            c = rescale(pm, M[None])
            out[h] = ((c[..., None] * pa).sum(0) / (c * pl).sum(0)[..., None])
            tickets[h] = 0
    assert tickets == [0] * H
    return out.to(cd)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def split_edges(heads: int, T: int, dtype, near: int, n: int = 2):
    """Positions from `near` on whose rows end at a split's last row or
    first row, or whose new rows straddle two splits."""
    out = []
    for pos in range(near, S - T + 1):
        R, _ = split_plan(heads, pos + T, D, dtype)
        if (pos + T) % R in (0, 1) or (T == 2 and pos % R == R - 1):
            out.append(pos)
            if len(out) == n:
                break
    return out


def positions(heads: int, T: int, dtype):
    return sorted({0, 1, *split_edges(heads, T, dtype, 2, 3),
                   *split_edges(heads, T, dtype, 1000), S - 2})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("heads", [2, 12, 96])
def test_split_model_matches_plain(heads, T, dtype):
    rng = np.random.default_rng(100 * heads + 10 * T + (dtype == torch.bfloat16))
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
    kc, vc = r(heads, S, D), r(heads, S, D)
    for pos in positions(heads, T, dtype):
        q, kn, vn = r(heads, T, D), r(heads, T, D), r(heads, T, D)
        kp, vp = kc.clone(), vc.clone()
        kp[:, pos + T :], vp[:, pos + T :] = float("nan"), float("nan")
        want, kp, vp = decode_attention_plain(q, kn, vn, kp, vp, pos)
        km, vm = kc.clone(), vc.clone()
        km[:, pos:], vm[:, pos:] = float("nan"), float("nan")
        got = kernel_model(q, kn, vn, km, vm, pos, rng)
        assert torch.isfinite(want.float()).all() and torch.isfinite(got.float()).all()
        assert torch.equal(km[:, : pos + T], kp[:, : pos + T])
        assert torch.equal(vm[:, : pos + T], vp[:, : pos + T])
        assert torch.isnan(km[:, pos + T :]).all() and torch.isnan(vm[:, pos + T :]).all()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        else:
            a, b = got.float(), want.float()
            assert ((a - b).abs() <= bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 2, 12, 48, 96, 132, 200])
def test_every_row_is_owned_by_exactly_one_split_and_lane(heads, dtype):
    """For every pos + T of a 2048-row cache: R is a multiple of the lane
    groups, the blocks fit on 132 SMs at 3 an SM at once (or there is one
    block a head), no split takes more passes than the card's room forces,
    and each row < pos + T falls to one split, one lane group, one pass and
    one slot of it."""
    NG = lane_groups(D, dtype)
    for rows in range(1, 2049):
        R, nsplit = split_plan(heads, rows, D, dtype)
        assert R % NG == 0 and 1 <= nsplit <= max_splits(heads)
        assert heads * nsplit <= max(3 * 132, heads)
        assert nsplit == max_splits(heads) or R <= NG * DA_U
        assert (nsplit - 1) * R < rows <= nsplit * R  # no empty split
        if rows in (2, 1002, 1602, 2048):
            own = np.zeros(rows, dtype=np.int64)
            for s in range(nsplit):
                r0, r1 = s * R, min(s * R + R, rows)
                for base in range(r0, r1, NG * DA_U):
                    j = (base + np.arange(DA_U)[:, None] * NG + np.arange(NG)[None, :]).ravel()
                    np.add.at(own, j[j < r1], 1)
            assert (own == 1).all()


def test_plan_at_the_published_shapes():
    """12 heads at pos 1000 (batch 1): 8 splits of one 128-row pass;
    96 heads at pos 1600 (batch 8): 4 splits of 416 rows, 384 blocks."""
    assert split_plan(12, 1002, 64, torch.bfloat16) == (128, 8)
    assert split_plan(96, 1602, 64, torch.bfloat16) == (416, 4)
    assert split_plan(48, 1002, 64, torch.bfloat16) == (128, 8)
    assert split_plan(12, 2, 64, torch.bfloat16) == (16, 1)
    assert lane_groups(64, torch.bfloat16) == 16 and lane_groups(64, torch.float32) == 8
