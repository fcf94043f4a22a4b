"""The slow step's split-row attention, modelled on the CPU.

`csrc/slow_decode.cu` splits each head's pos + 2 rows (cache rows < pos,
then the two fresh rows) into runs of rows, one block each; a block keeps
per query its max, its sum of exp(s - max) and its unnormalized value sum,
and the last block of a head merges them in split order.  The model below
repeats that arithmetic in PyTorch (it is not part of the package) and must
agree with the attention of `slow_decode_step_plain` (`slow_attention_plain`,
itself held against the JAX Pallas kernel by tests/test_torch_dual_ar.py):
float32 within 1e-5 (the two differ by summation order only), bf16 within
one bf16 ulp of the output, with empty splits and with the cache rows at
and beyond pos poisoned with NaN.
"""

import numpy as np
import pytest
import torch

from streamvoiceanon_tpu_torch.ops.decode_common import freqs_table, rope_rows
from streamvoiceanon_tpu_torch.ops.slow_decode import slow_attention, slow_attention_plain

H, HD, S = 2, 8, 48
DIM = H * HD


def split_model(qkv, kc, vc, pos, nsplit):
    """The kernel's arithmetic: S rows in nsplit runs; splits that start at
    or beyond pos + 2 take no part; the rest merge in order."""
    wd, cd = qkv.dtype, kc.dtype
    fr = freqs_table(S, HD, 10000.0, qkv.device)[pos : pos + 2]
    q32, k32, v = qkv[:, :DIM].float(), qkv[:, DIM : 2 * DIM].float(), qkv[:, 2 * DIM :]
    q = rope_rows(q32, fr, H).to(wd).to(cd).reshape(2, H, HD)
    kr = rope_rows(k32, fr, H).to(wd).to(cd)
    P = pos + 2
    keys = torch.cat([kc[:pos], kr]).reshape(P, H, HD)
    vals = torch.cat([vc[:pos].float(), v.float()]).reshape(P, H, HD)
    scale = np.float32(1.0) / np.sqrt(np.float32(HD))
    rows = -(-S // nsplit)
    parts = []
    for r0 in range(0, P, rows):
        j = torch.arange(r0, min(r0 + rows, P))
        s = (keys[j][None] * q[:, None]).float().sum(-1) * float(scale)  # (2, n, H)
        valid = (j[None, :] <= pos + torch.arange(2)[:, None])[..., None]
        s = torch.where(valid, s, float("-inf"))
        m = torch.amax(s, dim=1)  # (2, H), -inf where no row is valid
        e = torch.where(valid, torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[:, None]), 0.0)
        parts.append((m, e.sum(1), torch.einsum("tjh,jhd->thd", e, vals[j])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros(2, H, HD)
    den = torch.zeros(2, H)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den[..., None]).reshape(2, DIM).to(wd)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nsplit", [1, 3, 16])
@pytest.mark.parametrize("pos", [0, 1, 5, 37])
def test_split_attention_matches_plain(dtype, nsplit, pos):
    rng = np.random.default_rng(1000 * nsplit + pos)
    qkv = torch.from_numpy(rng.standard_normal((2, 3 * DIM)).astype(np.float32)).to(dtype)
    kc = torch.from_numpy(rng.standard_normal((S, DIM)).astype(np.float32)).to(dtype)
    vc = torch.from_numpy(rng.standard_normal((S, DIM)).astype(np.float32)).to(dtype)
    kc[pos:], vc[pos:] = float("nan"), float("nan")
    want, k_rows, v_rows = slow_attention_plain(qkv, kc, vc, pos, n_head=H, head_dim=HD)
    got = split_model(qkv, kc, vc, pos, nsplit)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    assert torch.isfinite(k_rows).all() and torch.isfinite(v_rows).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        a, b = got.float(), want.float()
        assert ((a - b).abs() <= bf16_ulp(torch.maximum(a.abs(), b.abs()))).all()


def test_attention_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 3 * DIM)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((S, DIM)).astype(np.float32))
    got = slow_attention(qkv, kc, kc.clone(), 9, n_head=H, head_dim=HD)
    want = slow_attention_plain(qkv, kc, kc.clone(), 9, n_head=H, head_dim=HD)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
