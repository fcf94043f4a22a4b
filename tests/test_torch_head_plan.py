"""The HiFiGAN head kernel's level plan, and a model of the kernel, on the CPU.

`_geometry` (ops/hifigan.py) hands csrc/hifigan_head.cu its launches as
plain integers: per dependency level, one record per conv (`CONV_FIELDS`).
The plan is checked at the published geometry (37 levels, every one of the
97 convs in exactly one) and for its tiles and K splits.  Then `_model`
reads the same integers as the kernel's host code does and runs the
launches in PyTorch: each level's blocks in a shuffled order (blocks run in
no order on the card), each block's K-chunks of its tile into its partial,
a ticket a tile, and the last block to arrive summing the splits in split
order.  A level reads only a snapshot of the buffers taken at its start (as
the dependency between launches guarantees, no more), the scratch and the
partials start as NaN, and every output element is written exactly once a
level.  Held to `head_stream_step_plain` over four chunks: waveform and
every packed tail within 1e-5 in float32 (the K-splits sum in another order
than one matmul).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.ops import hifigan as headops

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5

GEOMETRIES = {
    # tests/test_torch_hifigan_head.py
    "pallas_tiny": C.HiFiGANConfig(
        num_mels=16, upsample_initial_channel=16, upsample_rates=(2, 2),
        upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 2), (1, 2)), pre_conv_kernel_size=5,
        post_conv_kernel_size=5, hop_length=4),
    "converter_tiny": C.HiFiGANConfig(num_mels=32, upsample_initial_channel=32,
                                      pre_conv_kernel_size=7, post_conv_kernel_size=7),
    # wide enough that every level splits K across many blocks
    "split_heavy": C.HiFiGANConfig(
        num_mels=64, upsample_initial_channel=128, upsample_rates=(4, 2),
        upsample_kernel_sizes=(8, 4), pre_conv_kernel_size=7, post_conv_kernel_size=7),
    # more branches than one launch runs: rounds in several launches, and a
    # branch mean over more buffers than the kernel loads ahead
    **chip_smoke.branch_heads(),
}


def _params(cfg, seed):
    """Packed head weights with random biases, scaled by fan-in."""
    rng = np.random.default_rng(seed)

    def conv(k, ci, co):
        return {"w": (rng.standard_normal((k, ci, co)) / np.sqrt(k * ci)).astype(np.float32),
                "b": (rng.standard_normal(co) * 0.1).astype(np.float32)}

    chans = headops.stage_channels(cfg)
    h = {"conv_pre": conv(cfg.pre_conv_kernel_size, cfg.num_mels, chans[0][0]),
         "ups": [conv(k, ci, co) for k, (ci, co) in zip(cfg.upsample_kernel_sizes, chans)],
         "resblocks": [[{"convs1": [conv(rk, co, co) for _ in rd],
                         "convs2": [conv(rk, co, co) for _ in rd]}
                        for rk, rd in zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes)]
                       for _, co in chans],
         "conv_post": conv(cfg.post_conv_kernel_size, chans[-1][1], 1)}
    return headops.packed_weights(P.hifigan_params(h, "cpu"), cfg)


def _levels(geo):
    """The levels of `geo` as the kernel's host code reads them: per level
    its tile (rows, columns) and its conv records."""
    nf, p, levels = len(headops.CONV_FIELDS), headops.HDR, []
    for _ in range(geo[0]):
        n, tm, tn = geo[p : p + headops.LVL]
        p += headops.LVL
        levels.append(((tm, tn), [dict(zip(headops.CONV_FIELDS, geo[p + i * nf : p + (i + 1) * nf]))
                                  for i in range(n)]))
        p += n * nf
    assert p == len(geo)
    return levels


def _convs(geo):
    return [lv for _, lv in _levels(geo)]


def _silu(v):
    return v / (1.0 + torch.exp(-v))


def _model(geo, w, st_in, x, wav_len, rng):
    """Run the plan's launches (float32): returns (st_out, wav)."""
    n_level, n_buf, be, part_elems, n_ticket = geo[: headops.HDR]
    KC, PART = headops.KC, headops.PART
    nan = float("nan")
    bufs = {headops.BUF_X: x.reshape(-1).clone(), headops.BUF_WAV: torch.full((wav_len,), nan)}
    for i in range(n_buf):
        bufs[headops.BUF_FIRST + i] = torch.full((be,), nan)
    st_out = [torch.full_like(t, nan) for t in st_in]
    tickets = np.zeros(n_ticket, dtype=np.int64)
    for (TM, TN), level in _levels(geo):
        snap = {k: v.clone() for k, v in bufs.items()}  # what earlier levels wrote
        part = torch.full((part_elems,), nan)  # stale partials
        written = {}
        items, tile0 = [], 0  # the work list: per conv, per tile, per split
        for ci, c in enumerate(level):
            tiles = c["tiles_m"] * c["tiles_n"]
            items += [(ci, tile0 + t, t, q) for t in range(tiles) for q in range(c["ksplit"])]
            tile0 += tiles
        assert tile0 <= n_ticket and len(items) * PART <= part_elems
        fulls = []
        for c in level:
            T, cin, rows = c["T"], c["cin"], c["rows"]
            tail = st_in[c["tail"]].reshape(-1)[c["tail_off"] : c["tail_off"]
                                                 + c["rows_pad"] * cin].view(-1, cin)
            xs = [snap[c["x"] + m][: T * cin] for m in range(c["x_n"])]
            xin = xs[0]
            for v in xs[1:]:
                xin = xin + v
            if c["x_n"] > 1:
                xin = xin / float(c["x_n"])
            xin = xin.view(T, cin)
            full = torch.cat([tail[:rows], _silu(xin) if c["silu"] else xin])
            new = st_out[c["tail"]].reshape(-1)[c["tail_off"] : c["tail_off"]
                                                 + c["rows_pad"] * cin].view(-1, cin)
            new[:rows] = full[T : T + rows]
            new[rows:] = tail[rows:]
            cols = torch.cat([full[j * c["d"] : j * c["d"] + T] for j in range(c["k"])], 1)
            kw = cin if c["w2"] >= 0 else c["k"] * cin
            W = w[c["w"]].reshape(-1)[c["w_off"] : c["w_off"] + kw * c["n"]].view(kw, c["n"])
            if c["w2"] >= 0:
                W = torch.cat([W, w[c["w2"]].reshape(-1)[: cin * c["n"]].view(cin, c["n"])])
            fulls.append((cols, W))
        for bi in rng.permutation(len(items)):
            ci, tk, t, q = items[bi]
            c, (cols, W) = level[ci], fulls[ci]
            T, N, K = c["T"], c["n"], c["k"] * c["cin"]
            m0, n0 = (t // c["tiles_n"]) * TM, (t % c["tiles_n"]) * TN
            m1, n1 = min(T, m0 + TM), min(N, n0 + TN)
            k0, k1 = q * c["per"] * KC, min(K, (q + 1) * c["per"] * KC)
            acc = cols[m0:m1, k0:k1] @ W[k0:k1, n0:n1]
            if c["ksplit"] > 1:
                pb = part[bi * PART : bi * PART + TM * TN].view(TM, TN)
                pb[: m1 - m0, : n1 - n0] = acc
                tickets[tk] += 1
                if tickets[tk] < c["ksplit"]:
                    continue
                first = bi - q
                acc = torch.zeros_like(acc)
                for s in range(c["ksplit"]):
                    ps = part[(first + s) * PART : (first + s) * PART + TM * TN].view(TM, TN)
                    acc = acc + ps[: m1 - m0, : n1 - n0]
                tickets[tk] = 0
            y = acc + w[c["b"]].reshape(-1)[c["b_off"] + torch.arange(n0, n1) % c["bias_mod"]]
            idx = (torch.arange(m0, m1)[:, None] * N + torch.arange(n0, n1)[None]).reshape(-1)
            if c["resid"] >= 0:
                y = y + snap[c["resid"]][idx].view_as(y)
            if c["tanh"]:
                y = torch.tanh(y)
            bufs[c["out"]][idx] = y.reshape(-1)
            cnt = written.setdefault(c["out"], torch.zeros(len(bufs[c["out"]]), dtype=torch.int32))
            cnt[idx] += 1
        for ci, c in enumerate(level):  # every output element once a level
            cnt = written[c["out"]][: c["T"] * c["n"]]
            assert (cnt == 1).all(), (ci, c)
        assert (tickets == 0).all()
    return st_out, bufs[headops.BUF_WAV]


def _leaves(state):
    return [state.pre, *state.ups, *state.res, state.post]


def _random_state(cfg, rng):
    z = headops.init_packed_state(cfg, 1)
    r = lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
    return headops.PackedHeadState(r(z.pre), tuple(r(t) for t in z.ups),
                                   tuple(r(t) for t in z.res), r(z.post))


def _model_step(pw, state, x, cfg, rng):
    """One head step through `_model`, with the wrapper's argument order."""
    w = [pw["pre_w"], pw["pre_b"]]
    for st in pw["stages"]:
        w += [st["wa"], st["wb"], st["ub"], st["rw"], st["rb"]]
    w += [pw["post_w"], pw["post_b"]]
    st_in = [state.pre]
    for u, r in zip(state.ups, state.res):
        st_in += [u, r]
    st_in.append(state.post)
    n = len(cfg.upsample_rates)
    T0 = x.shape[1]
    out, wav = _model(headops._geometry(cfg, T0), w, st_in, x[0],
                      T0 * int(np.prod(cfg.upsample_rates)), rng)
    return (headops.PackedHeadState(out[0], tuple(out[1 : 1 + 2 * n : 2]),
                                    tuple(out[2 : 2 + 2 * n : 2]), out[-1]), wav[None])


def test_published_plan_has_37_levels_and_every_conv_once():
    cfg = C.HiFiGANConfig()
    levels = _convs(headops._geometry(cfg, 4))
    assert len(levels) == 37 == headops.device_launches(cfg, 4)
    assert [len(lv) for lv in levels] == [1] + ([1] + [3] * 6) * 5 + [1]
    # a conv is known by its weights and by its tail slot: 97 of each, each once
    by_weight = [(c["w"], c["w_off"]) for lv in levels for c in lv]
    by_tail = [(c["tail"], c["tail_off"]) for lv in levels for c in lv]
    assert len(by_weight) == 97 == len(set(by_weight)) == len(set(by_tail))
    # the three branches of a round write their own buffers, none shared
    for lv in levels:
        assert len({c["out"] for c in lv}) == len(lv)
    # the branch mean is loaded by the next upsample and by conv_post
    means = [(i, c["x_n"]) for i, lv in enumerate(levels) for c in lv if c["x_n"] > 1]
    assert means == [(8, 3), (15, 3), (22, 3), (29, 3), (36, 3)]


@pytest.mark.parametrize("name", sorted(chip_smoke.branch_heads()))
def test_rounds_of_more_branches_than_a_launch_runs(name):
    """Each round of nb > MAX_CONV branches runs as ceil(nb / MAX_CONV)
    launches of at most MAX_CONV convs, every branch in one of them, in
    branch order; the next upsample and conv_post average all nb D_b."""
    cfg = GEOMETRIES[name]
    nb, n_dil = len(cfg.resblock_kernel_sizes), len(cfg.resblock_dilation_sizes[0])
    assert nb > headops.MAX_CONV
    per_round = [headops.MAX_CONV] * (nb // headops.MAX_CONV) + (
        [nb % headops.MAX_CONV] if nb % headops.MAX_CONV else [])
    levels = _convs(headops._geometry(cfg, 4))
    stage = [1] + per_round * 2 * n_dil
    assert [len(lv) for lv in levels] == [1] + stage * len(cfg.upsample_rates) + [1]
    assert headops.device_launches(cfg, 4) == len(levels)
    assert all(len(lv) <= headops.MAX_CONV for lv in levels)
    d0 = levels[2][0]["out"] + nb  # D_0: after the C_b
    means = [(i, c["x"], c["x_n"]) for i, lv in enumerate(levels) for c in lv if c["x_n"] > 1]
    assert means == [(i, d0, nb) for i in range(len(stage) + 1, len(levels), len(stage))]
    by_weight = [(c["w"], c["w_off"]) for lv in levels for c in lv]
    n_conv = 2 + len(cfg.upsample_rates) * (1 + 2 * n_dil * nb)  # every conv once
    assert len(by_weight) == len(set(by_weight)) == n_conv


@pytest.mark.parametrize("name", [*sorted(GEOMETRIES), "published"])
def test_splits_cover_every_chunk_once_and_fill_the_card(name):
    cfg = C.HiFiGANConfig() if name == "published" else GEOMETRIES[name]
    geo = headops._geometry(cfg, 4)
    for (tm, tn), lv in _levels(geo):
        assert (tm, tn) in headops.TILES
        assert all(c["tiles_m"] == -(-c["T"] // tm) and c["tiles_n"] == -(-c["n"] // tn)
                   for c in lv)
        nch = [-(-c["k"] * c["cin"] // headops.KC) for c in lv]
        work = sum(c["tiles_m"] * c["tiles_n"] * n for c, n in zip(lv, nch))
        per = -(-work // headops.TARGET_BLOCKS)  # one split length a level: equal work
        for c, n in zip(lv, nch):
            assert c["per"] == min(per, n)
            assert (c["ksplit"] - 1) * c["per"] < n <= c["ksplit"] * c["per"]
        blocks = sum(c["tiles_m"] * c["tiles_n"] * c["ksplit"] for c in lv)
        assert blocks * headops.PART <= geo[3]
        if name == "published":  # about four blocks a SM or fewer
            assert blocks <= 1.1 * headops.TARGET_BLOCKS


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_model_of_the_plan_matches_the_plain_head(name):
    cfg = GEOMETRIES[name]
    pw = _params(cfg, 3)
    rng = np.random.default_rng(7)
    sm = sp = _random_state(cfg, rng)
    for c in range(4):
        x = torch.from_numpy(rng.standard_normal((1, 4, cfg.num_mels)).astype(np.float32))
        sm, wm = _model_step(pw, sm, x, cfg, rng)
        sp, wp = headops.head_stream_step_plain(pw, sp, x, cfg)
        assert wm.shape == wp.shape
        for a, b in zip([wm, *_leaves(sm)], [wp, *_leaves(sp)]):
            assert torch.isfinite(a).all(), f"chunk {c}"
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL, msg=f"chunk {c}")
    if name == "split_heavy":
        assert any(c["ksplit"] > 8 for lv in _convs(headops._geometry(cfg, 4)) for c in lv)


def test_block_order_does_not_change_the_result():
    cfg = GEOMETRIES["split_heavy"]
    pw = _params(cfg, 4)
    rng = np.random.default_rng(8)
    st = _random_state(cfg, rng)
    x = torch.from_numpy(rng.standard_normal((1, 4, cfg.num_mels)).astype(np.float32))
    a = _model_step(pw, st, x, cfg, np.random.default_rng(1))
    b = _model_step(pw, st, x, cfg, np.random.default_rng(2))
    for u, v in zip([a[1], *_leaves(a[0])], [b[1], *_leaves(b[0])]):
        assert torch.equal(u, v)


def test_plan_constants_match_the_cuda_source():
    src = (ROOT / "streamvoiceanon_tpu_torch" / "csrc" / "hifigan_head.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name in ("KC", "PART", "MAX_CONV", "HDR", "LVL"):
        assert int(const[name]) == getattr(headops, name), name
    launched = re.findall(r"launch_pdl\(level_kernel<(\d+), (\d+), W, S, WIDE>", src)
    assert [(int(a), int(b)) for a, b in launched] == list(headops.TILES)
    enum = re.search(r"enum Field \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names == ["F_" + f.upper() for f in headops.CONV_FIELDS] + ["NF"]


def test_scratch_and_geo_are_kept_across_calls():
    cfg = GEOMETRIES["pallas_tiny"]
    s1, floats = headops.kept_scratch(cfg, 4, "cpu")
    s2, _ = headops.kept_scratch(cfg, 4, "cpu")
    assert s1 is s2 and headops.kept_scratch(cfg, 8, "cpu")[0] is not s1
    geo = headops._geometry(cfg, 4)
    n_buf, be, part_elems, n_ticket = geo[1:5]
    assert floats == n_buf * be + part_elems and s1.numel() == floats + n_ticket
    assert (s1[floats:].view(torch.int32) == 0).all()  # tickets start at zero
