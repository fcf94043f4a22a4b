"""Plain PyTorch pieces shared by the two decode kernels' plain versions, the
scratch sizes their CUDA launches need, and the column plan, packed weights
and grid-barrier counts of the two persistent kernels (the fast loop,
csrc/fast_decode.cu, and the ring step, csrc/wt_stream.cu).

The arithmetic follows the TPU kernels the two CUDA kernels replace
(JAX package, ops/pallas_slow_decode.py and ops/pallas_fast_decode.py):
matrix products accumulate in float32 and round to the weight dtype, and
the sampler is the exact full-vocabulary nucleus filter found by bisection.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.ops.rope import precompute_freqs_cis

# must match MV_KC and the smallest MV_TX * Vec<W>::N in csrc/decode_common.cuh
MV_KC = 128
MV_MIN_TILE_COLS = 32


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with float32 accumulation, rounded to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def rope_rows(x32: torch.Tensor, fr: torch.Tensor, n_head: int) -> torch.Tensor:
    """Interleaved-pair RoPE of flat rows x32 (T, n_head*hd) with the table
    rows fr (T, hd/2, 2) of their positions, in float32."""
    T, dim = x32.shape
    xs = x32.reshape(T, n_head, -1, 2)
    c, s = fr[:, None, :, 0], fr[:, None, :, 1]
    x0, x1 = xs[..., 0], xs[..., 1]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(T, dim)


@functools.lru_cache(maxsize=16)
def freqs_table(rows: int, head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """The (rows, head_dim/2, 2) float32 RoPE table on `device`."""
    return torch.from_numpy(precompute_freqs_cis(rows, head_dim, base)).to(device)


def nucleus_race(logits: torch.Tensor, gumbel: Optional[torch.Tensor], *,
                 greedy: bool, temperature: float, top_p: float) -> torch.Tensor:
    """(V,) float32 logits -> the (V,) values whose first maximum is the
    token: the logits when greedy, else the exact nucleus filter (keep
    {i : p_i > lo}, lo the 40-step bisection threshold of "probability mass
    strictly above <= top_p"; -inf elsewhere) over the temperature, plus
    the Gumbel noise."""
    if greedy:
        return logits
    tmax = torch.full((), max(temperature, 1e-5), dtype=torch.float32, device=logits.device)
    if top_p < 1.0:
        e = torch.exp(logits - torch.max(logits))
        probs = e / torch.sum(e)
        lo = torch.zeros((), dtype=torch.float32, device=logits.device)
        hi = torch.ones((), dtype=torch.float32, device=logits.device)
        for _ in range(40):
            mid = (lo + hi) * 0.5
            kept = torch.sum(torch.where(probs > mid, probs, 0.0)) <= top_p
            lo, hi = torch.where(kept, lo, mid), torch.where(kept, mid, hi)
        logits = torch.where(probs > lo, logits, float("-inf"))
    return logits / tmax + gumbel


def nucleus_sample(logits: torch.Tensor, gumbel: Optional[torch.Tensor], *,
                   greedy: bool, temperature: float, top_p: float) -> torch.Tensor:
    """(V,) float32 logits -> (1,) int32 token: the first maximum of
    `nucleus_race` (ties go to the lowest index).  No host synchronization."""
    race = nucleus_race(logits, gumbel, greedy=greedy, temperature=temperature, top_p=top_p)
    col = torch.arange(race.shape[-1], device=logits.device)
    tok = torch.min(torch.where(race == torch.max(race), col, race.shape[-1]))
    return tok.to(torch.int32).reshape(1)


def matvec_scratch(rows: int, shapes, device):
    """(partials, counters) for the CUDA matvec launches of one call;
    `shapes` lists (K, N, n_matrices) of every launch."""
    part = max(nmat * -(-K // MV_KC) * rows * N for K, N, nmat in shapes)
    tiles = max(-(-N // MV_MIN_TILE_COLS) for _, N, _ in shapes)
    return (torch.empty(part, dtype=torch.float32, device=device),
            torch.zeros(tiles, dtype=torch.int32, device=device))


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, tensors: dict, dtype=None):
    """Device, dtype and contiguity checks before a CUDA launch."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dtype}")
    return dev


# ---------------------------------------------------------------------------
# the persistent kernels: column plan, packed weights, grid-barrier counts
# ---------------------------------------------------------------------------

MAX_SMEM = 232448  # shared memory a block may use on Hopper (227 KB)
COOPERATIVE_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge


def unit_cols(dtype) -> int:
    """Output columns of one plan unit: 16 bytes of a weight row."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def column_plan(units: Sequence[int], unit_bytes: Sequence[int], n_blocks: int) -> np.ndarray:
    """(n_blocks, phases, 2) int32: per block and phase, the first unit it
    owns and how many, a contiguous run.

    Every block gets floor(units / n_blocks) units of a phase; the rest go
    one each to the blocks with the fewest weight bytes so far, phases with
    the largest units first (lowest block index on ties), so that a block's
    bytes stay near the mean and no block has more than ceil(units /
    n_blocks) units of a phase."""
    load = np.zeros(n_blocks, dtype=np.int64)
    counts = np.zeros((n_blocks, len(units)), dtype=np.int64)
    for p in sorted(range(len(units)), key=lambda p: -unit_bytes[p]):
        base, extra = divmod(units[p], n_blocks)
        counts[:, p] = base
        load += base * unit_bytes[p]
        least = np.lexsort((np.arange(n_blocks), load))[:extra]
        counts[least, p] += 1
        load[least] += unit_bytes[p]
    first = np.cumsum(counts, axis=0) - counts
    return np.stack([first, counts], axis=-1).astype(np.int32)


_PACKED: Dict[Tuple, Tuple[torch.Tensor, int, torch.Tensor]] = {}
_PACKED_MAX = 48  # eight weight sets of six matrices


def packed(w: torch.Tensor) -> torch.Tensor:
    """w (..., K, N) as (..., N / u, K, u), u = unit_cols: each unit's
    column slice contiguous over the whole K.  Kept per source tensor and
    its version counter (an in-place update packs again); the entry holds
    the source, so its address is not reused while the entry lives."""
    key = (w.data_ptr(), w.dtype, tuple(w.shape), w.device)
    hit = _PACKED.get(key)
    if hit is not None and hit[0] is w and hit[1] == w._version:
        return hit[2]
    u = unit_cols(w.dtype)
    *lead, K, N = w.shape
    p = w.reshape(*lead, K, N // u, u).transpose(-3, -2).contiguous()
    _PACKED.pop(key, None)
    while len(_PACKED) >= _PACKED_MAX:
        _PACKED.pop(next(iter(_PACKED)))
    _PACKED[key] = (w, w._version, p)
    return p


_BAR_COUNTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def barrier_count(kernel: str, dev: torch.device) -> torch.Tensor:
    """The grid barrier's arrival count of one persistent kernel on `dev`:
    zeroed once, and left at a multiple of the grid by every launch, so it
    is shared by all launches of that kernel (each kernel has its own, so
    two kernels on two streams never share one)."""
    key = (kernel, dev)
    if key not in _BAR_COUNTS:
        _BAR_COUNTS[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _BAR_COUNTS[key]
