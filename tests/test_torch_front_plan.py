"""The ConvNeXt front's plan, and a model of its persistent kernel, on the CPU.

`phases` and `work_plan` (ops/convnext_enc.py) give every block of the one
cooperative launch its columns of each phase's product; csrc/convnext_enc.cu
walks the same phases and reads the plan as is.  The plan is checked at the
published geometry (stem 160 -> 128, blocks 3-3-9-3 at 128..512, two
stride-2 downsamples to 512; 132 blocks), at two tiny ones, one with fewer
column units than blocks in some phases, and at three the kernel takes
since its rows follow the plan: rows of 1024 (wider than its 512
threads), a downsample product of 8 (8 frames a launch), and widths that
are no multiple of 4 without a downsample (ragged units, the final-LN
phase).  Then `_model_call` runs a
call phase by phase as the kernel does: each block recomputes the row-wise
steps from the whole input rows, computes only its own columns over the
whole K from the unit-packed matrices (`unit_weights`), reads what other
blocks wrote only from a snapshot taken at the last grid barrier (as the
barriers guarantee, no more), runs in shuffled order, and writes every
output once a phase; the kept scratch starts as NaN and is carried across
calls.  Held to `encoder_front_step_plain` in float32 within 1e-5 (column
slices add in another order than the whole products) on z and every packed
buffer over 4 consecutive chunks.  Last, the converter packs the units once
per parameter tree and `encode_stream` hands the same ones to every call.
"""

import dataclasses
import re
from dataclasses import replace as drep
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import tokenizer_stream as tts
from streamvoiceanon_tpu_torch.ops import convnext_enc as enc
from streamvoiceanon_tpu_torch.ops.decode_common import MAX_SMEM
from streamvoiceanon_tpu_torch.ops.norm import layer_norm

PUBLISHED = C.all_five(C.PipelineConfig()).tokenizer
TINY = C.replace(C.TokenizerConfig(), quantizer=C.BSQConfig(input_dim=32),
                 backbone=C.ConvNeXtConfig(depths=(2, 1, 3, 1), dims=(16, 24, 28, 32)),
                 use_pallas_encoder=True)
SMALL = C.replace(C.TokenizerConfig(), quantizer=C.BSQConfig(input_dim=16),
                  backbone=C.ConvNeXtConfig(input_channels=12, depths=(1, 2),
                                            dims=(8, 16)),
                  use_pallas_encoder=True)
# rows wider than the kernel's 512 threads
WIDE = C.replace(C.TokenizerConfig(), quantizer=C.BSQConfig(input_dim=1024),
                 backbone=C.ConvNeXtConfig(input_channels=160, depths=(1, 1, 1, 1),
                                           dims=(192, 384, 768, 1024)),
                 use_pallas_encoder=True)
# a downsample product of 8: one launch takes 8 frames
DOWN8 = C.replace(TINY, quantizer=C.BSQConfig(input_dim=32, downsample_factor=(2, 2, 2)))
# widths that are not multiples of 4, and no downsample (the final LN phase)
RAGGED = C.replace(C.TokenizerConfig(), quantizer=C.BSQConfig(input_dim=22,
                                                              downsample_factor=()),
                   backbone=C.ConvNeXtConfig(input_channels=10, depths=(1, 2),
                                             dims=(18, 22)),
                   use_pallas_encoder=True)
# (config, blocks)
GEOMETRIES = {"published": (PUBLISHED, 132), "tiny": (TINY, 5), "small": (SMALL, 7),
              "wide": (WIDE, 132), "down8": (DOWN8, 6), "ragged": (RAGGED, 4)}


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_every_column_of_every_phase_is_owned_once(geo):
    cfg, G = GEOMETRIES[geo]
    ph = enc.phases(cfg)
    plan = enc.work_plan(cfg, G)
    assert plan.shape == (G, len(ph), 2) and plan.dtype == np.int32
    fewer = False
    for p, phase in enumerate(ph):
        n_units = -(-phase.N // enc.UNIT)
        owned = np.zeros(n_units, dtype=int)
        for first, n in plan[:, p]:
            assert n >= 0 and 0 <= first and first + n <= n_units
            owned[first : first + n] += 1
        assert (owned == 1).all(), phase
        # no block waits on more than its share of a phase
        assert plan[:, p, 1].max() == -(-n_units // G)
        fewer |= n_units < G
    if geo == "tiny":
        assert fewer  # some phases leave blocks idle


def test_published_geometry_has_46_phases():
    ph = enc.phases(PUBLISHED)
    assert len(ph) == 46
    kinds = [p.kind for p in ph]
    assert {k: kinds.count(k) for k in set(kinds)} == {"stem": 1, "P": 20, "Q": 20, "M": 3,
                                                         "D": 2}
    assert ph[0] == enc.Phase("stem", "stem", 7 * 160, 128)
    assert ph[1:3] == [enc.Phase("P", "s0b0", 128, 512), enc.Phase("Q", "s0b0", 512, 128)]
    assert ph[7] == enc.Phase("M", "m1", 128, 256)
    assert ph[-3:] == [enc.Phase("D", "d1", 1024, 512), enc.Phase("P", "d1b", 512, 2048),
                       enc.Phase("Q", "d1b", 2048, 512)]
    # the widest products move 4.2 MB
    assert max(p.K * p.N * 4 for p in ph) == 512 * 2048 * 4


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_a_block_fits_and_the_kernel_takes_the_geometry(geo):
    cfg, _ = GEOMETRIES[geo]
    enc.check_kernel_geometry(cfg, 132)
    assert enc.smem_bytes(cfg, 132) <= MAX_SMEM


def test_the_kernel_refuses_rows_wider_than_its_threads():
    """Rows wider than the 512 threads run (a thread takes several
    columns); the kernel refuses only what the JAX kernel refuses (a
    kernel size above 9) and a geometry whose rows overflow a block's
    shared memory."""
    wide = C.replace(TINY, backbone=C.ConvNeXtConfig(depths=(1,), dims=(640,)))
    enc.check_kernel_geometry(wide, 132)
    huge = C.replace(TINY, backbone=C.ConvNeXtConfig(depths=(1,), dims=(8192,)))
    with pytest.raises(ValueError, match="shared memory"):
        enc.check_kernel_geometry(huge, 132)
    k11 = C.replace(TINY, backbone=C.ConvNeXtConfig(depths=(1,), dims=(16,), kernel_size=11))
    with pytest.raises(ValueError, match="kernel_size > 9"):
        enc.check_kernel_geometry(k11, 132)


def test_front_constants_match_the_cuda_source():
    """The constants the wrapper mirrors from csrc/convnext_enc.cu, and the
    build each geometry takes: the published one the narrow build, whose
    records' integer fields K .. flags (PH_INTS) go in its launch
    parameters; a front of more than NARROW_PHASES phases the wide one."""
    src = (Path(enc.__file__).resolve().parent.parent / "csrc" / "convnext_enc.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", src))
    assert int(const["PH_FIELDS"]) == enc.PHASE_FIELDS
    assert int(const["PH_PARAMS"]) == enc.NARROW_PHASES
    assert int(const["RG"]) == enc.ROWS and int(const["SLOT"]) == enc.SLOT
    fields = re.search(r"enum PhaseField \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in fields.split(",")]
    assert names[1:8] == ["PF_K", "PF_N", "PF_C", "PF_KIND", "PF_SLOT", "PF_F", "PF_FLAGS"]
    assert enc._sizes(enc._geo_key(PUBLISHED), 132)["wide"] == 0
    deep = C.replace(TINY, backbone=C.ConvNeXtConfig(depths=(48,), dims=(32,)))
    assert len(enc.phases(deep)) > enc.NARROW_PHASES
    assert enc._sizes(enc._geo_key(deep), 132)["wide"] == 1


def _front(cfg, seed=41):
    tp = P.tokenizer_params(chip_smoke.front_tree_np(cfg, seed), "cpu")
    pw = enc.packed_weights(tp, cfg)
    return pw, enc.unit_weights(pw)


def test_units_are_column_slices_over_the_whole_k():
    pw, units = _front(TINY)
    for place, m, blocks in enc._matrices(pw):
        u = enc._unit_at(units, place)
        K = m.shape[0] // blocks
        assert u.shape == (blocks, -(-m.shape[1] // 4), K, 4) and u.is_contiguous()
        for b in range(blocks):
            for j in (0, u.shape[1] - 1):
                torch.testing.assert_close(u[b, j], m[b * K : (b + 1) * K, 4 * j : 4 * j + 4],
                                           rtol=0, atol=0)


def _cols(unit_stack, first, n):
    """The (K, 4 n) columns of units first .. first + n - 1 of one matrix."""
    u = unit_stack[first : first + n]
    return u.permute(1, 0, 2).reshape(u.shape[1], 4 * n)


def _model_call(pw, units, state, mel, cfg, n_blocks, order, kept):
    """The kernel's data flow in plain PyTorch (float32) for one call of T <=
    `launch_frames` frames: returns (state', z).  `kept` holds the flat buffers xa, xb and
    g, carried across calls as the kernel keeps them."""
    bb, q = cfg.backbone, cfg.quantizer
    k, S, eps = bb.kernel_size, enc.SLOT, enc.LN_EPS
    tr = k - 1
    T = mel.shape[1]
    G = n_blocks
    plan = enc.work_plan(cfg, G)
    nan = float("nan")
    live = dict(kept)
    live["z"] = torch.full((T // int(np.prod(q.downsample_factor)) * q.input_dim,), nan)
    st_in = [state.stem[0], *(s[0] for s in state.stages), state.down[0]]
    st_out = [torch.full_like(t, nan) for t in st_in]
    flat = [t.view(-1) for t in st_out]
    written = {}
    must = []

    def barrier():
        for key, cnt in written.items():  # no output twice a phase
            assert (cnt <= 1).all(), key
        for key, idx in must:  # each product's whole output once
            assert (written[key][idx] == 1).all(), key
        written.clear()
        must.clear()
        return {name: t.clone() for name, t in live.items()}

    def write(key, idx, val, buf=None):
        buf = live[key] if buf is None else buf
        buf[idx] = val
        written.setdefault(key, torch.zeros(buf.numel(), dtype=torch.int32))[
            idx.reshape(-1)] += 1

    def rows_idx(nrows, width, cols):
        return (torch.arange(nrows)[:, None] * width + cols[None, :])

    def ln(x, w, b):
        return layer_norm(x, w.reshape(-1), b.reshape(-1), eps)

    def tail_rows(tin, full, Tn, C):
        """The new tail slot: rows T .. T + k - 2 of [tail; x], then the kept rows."""
        return torch.cat([full[Tn : Tn + tr], tin[tr:S]]).reshape(-1)

    snap = barrier()
    cur, oth = "xa", "xb"
    Tn, C = T, bb.dims[0]
    for p, phase in enumerate(enc.phases(cfg)):
        stem_ln = p == 1  # the phase after the stem norms its rows first
        for b in order(G):
            first, n = plan[b, p]
            cols = torch.arange(4 * first, 4 * (first + n))
            cols = cols[cols < phase.N]
            if phase.kind == "stem":
                if n == 0 and b > 0:
                    continue
                cin = bb.input_channels
                full = torch.cat([st_in[0][:tr], mel[0]])
                im2col = torch.cat([full[j : j + T] for j in range(k)], dim=1)
                y = im2col @ _cols(units["stem_w"][0], first, n)[:, : len(cols)] \
                    + pw["stem_b"][0, cols]
                write("xa", rows_idx(T, C, cols), y)
                must.append(("xa", rows_idx(T, C, torch.arange(C))))
                if b == 0:
                    out = tail_rows(st_in[0], full, T, cin)
                    write("st0", torch.arange(out.numel()), out, flat[0])
            elif phase.kind == "M":
                i = int(phase.where[1:])
                m = pw["mids"][i - 1]
                if n == 0:
                    continue
                x = snap[cur][: Tn * C].reshape(Tn, C)
                if stem_ln:
                    x = ln(x, pw["stem_ln_w"], pw["stem_ln_b"])
                x = ln(x, m["ln_w"], m["ln_b"])
                y = x @ _cols(units["mids"][i - 1][0], first, n)[:, : len(cols)] + m["b"][0, cols]
                write(oth, rows_idx(Tn, phase.N, cols), y)
                must.append((oth, rows_idx(Tn, phase.N, torch.arange(phase.N))))
            elif phase.kind == "D":
                i = int(phase.where[1:])
                dp = pw["downs"][i]
                f = q.downsample_factor[i]
                if n == 0:
                    continue
                x = snap[cur][: Tn * C].reshape(Tn, C)
                if stem_ln:
                    x = ln(x, pw["stem_ln_w"], pw["stem_ln_b"])
                if i == 0:
                    x = ln(x, pw["final_ln_w"], pw["final_ln_b"])
                y = x.reshape(Tn // f, f * C) @ _cols(units["downs"][i]["w"][0], first,
                                                      n)[:, : len(cols)]
                write(oth, rows_idx(Tn // f, phase.N, cols), y + dp["b"][0, cols])
                must.append((oth, rows_idx(Tn // f, phase.N, torch.arange(phase.N))))
            elif phase.kind == "L":
                if n == 0:
                    continue
                x = snap[cur][: Tn * C].reshape(Tn, C)
                if stem_ln:
                    x = ln(x, pw["stem_ln_w"], pw["stem_ln_b"])
                x = ln(x, pw["final_ln_w"], pw["final_ln_b"])
                idx = rows_idx(Tn, C, cols)
                write("z", idx, x[:, cols])
                must.append(("z", rows_idx(Tn, C, torch.arange(C))))
            else:  # a block's P or Q
                if phase.where.startswith("s"):
                    i, bi = map(int, phase.where[1:].split("b"))
                    sp, su = pw["stages"][i], units["stages"][i]
                    tin = st_in[1 + i][bi * S : (bi + 1) * S]
                    okey, obuf, ooff = f"st{1 + i}", flat[1 + i], bi * S * C
                else:
                    i, bi = int(phase.where[1:-1]), 0
                    sp, su = pw["downs"][i]["blk"], units["downs"][i]
                    tin = st_in[-1][i * S : (i + 1) * S]
                    okey, obuf, ooff = "stdown", flat[-1], i * S * C
                hid = 4 * C
                if phase.kind == "P":
                    if n == 0 and b > 0:
                        continue
                    x = snap[cur][: Tn * C].reshape(Tn, C)
                    if stem_ln:
                        x = ln(x, pw["stem_ln_w"], pw["stem_ln_b"])
                        if b == 0:
                            write(oth, torch.arange(Tn * C), x.reshape(-1))
                    full = torch.cat([tin[:tr], x])
                    h = sum(full[j : j + Tn] * sp["dw_w"][bi, j] for j in range(k))
                    h = ln(h + sp["dw_b"][bi], sp["ln_w"][bi], sp["ln_b"][bi])
                    y = h @ _cols(su["pw1"][bi], first, n)[:, : len(cols)] \
                        + sp["pw1_b"][bi, cols]
                    idx = rows_idx(Tn, hid, cols)
                    write("g", idx, F.gelu(y))
                    must.append(("g", rows_idx(Tn, hid, torch.arange(hid))))
                    if b == 0:
                        out = tail_rows(tin, full, Tn, C)
                        write(okey, ooff + torch.arange(out.numel()), out, obuf)
                else:
                    if n == 0:
                        continue
                    last = p == len(enc.phases(cfg)) - 1
                    g = snap["g"][: Tn * hid].reshape(Tn, hid)
                    y = g @ _cols(su["pw2"][bi], first, n)[:, : len(cols)] \
                        + sp["pw2_b"][bi, cols]
                    idx = rows_idx(Tn, C, cols)
                    out = snap[cur][idx] + sp["gamma"][bi, cols] * y
                    write("z" if last else cur, idx, out)
                    must.append(("z" if last else cur, rows_idx(Tn, C, torch.arange(C))))
        # where each phase leaves x
        if phase.kind in ("M", "D") or stem_ln and phase.kind == "P":
            cur, oth = oth, cur
        if phase.kind == "M":
            C = phase.N
        if phase.kind == "D":
            Tn, C = Tn // q.downsample_factor[int(phase.where[1:])], phase.N
        if p + 1 < len(enc.phases(cfg)):
            snap = barrier()
    barrier()
    kept.update({name: live[name] for name in kept})
    n_stage = len(bb.depths)
    new = enc.PackedEncState(st_out[0][None], tuple(t[None] for t in st_out[1 : 1 + n_stage]),
                             st_out[-1][None])
    return new, live["z"].reshape(1, -1, q.input_dim)


def _state(cfg, rng):
    z = enc.init_packed_state(cfg, 1)
    r = lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
    return enc.PackedEncState(r(z.stem), tuple(r(t) for t in z.stages), r(z.down))


def _leaves(st):
    return [st.stem, *st.stages, st.down]


@pytest.mark.parametrize("geo", ["tiny", "small", "wide", "down8", "ragged"])
@pytest.mark.parametrize("n_blocks", [3, 5, 132])
def test_model_of_the_kernel_matches_the_plain_step(geo, n_blocks):
    cfg, _ = GEOMETRIES[geo]
    pw, units = _front(cfg, seed=n_blocks)
    rng = np.random.default_rng(11)
    shuffled = lambda G: rng.permutation(G).tolist()
    n = enc.kept_scratch(cfg, "cpu")["xa"].numel()
    kept = {"xa": torch.full((n,), float("nan")), "xb": torch.full((n,), float("nan")),
            "g": torch.full((4 * n,), float("nan"))}
    sm = sp = _state(cfg, rng)
    T = enc.launch_frames(cfg)
    Tz = T // int(np.prod(cfg.quantizer.downsample_factor))
    for chunk in range(4 if geo in ("tiny", "small") else 2):
        mel = torch.from_numpy(rng.standard_normal((1, T, cfg.backbone.input_channels))
                               .astype(np.float32))
        sm, zm = _model_call(pw, units, sm, mel, cfg, n_blocks, shuffled, kept)
        sp, zp = enc.encoder_front_step_plain(pw, sp, mel, cfg)
        assert zm.shape == zp.shape == (1, Tz, cfg.quantizer.input_dim)
        for a, b in zip([zm, *_leaves(sm)], [zp, *_leaves(sp)]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"chunk {chunk}")


J_PACKED = C.from_fields(drep(tiny_config().tokenizer, use_pallas_encoder=True))


def test_the_converter_packs_the_units_once_and_every_call_reads_them(monkeypatch):
    tp = P.tokenizer_params(chip_smoke.front_tree_np(J_PACKED), "cpu")
    calls = []
    pack = enc.unit_weights
    monkeypatch.setattr(enc, "unit_weights", lambda pw: calls.append(1) or pack(pw))
    cfg = C.replace(C.PipelineConfig(), tokenizer=J_PACKED)
    cv = P.Converter(cfg=cfg, tokenizer_params=tp, vocoder_params={}, arvc_params={},
                     device=torch.device("cpu"))
    units = cv.tokenizer_params["enc_units"]
    again = dataclasses.replace(cv, cfg=cfg)
    assert len(calls) == 1 and again.tokenizer_params["enc_units"] is units
    seen = []
    front = enc.encoder_front_step
    monkeypatch.setattr(enc, "encoder_front_step",
                        lambda pw, st, mel, c, units=None: seen.append(units) or front(
                            pw, st, mel, c))
    state = tts.init_stream_state(cv.tokenizer_params, J_PACKED)
    consts = tts.mel_consts(J_PACKED.mel)
    wav = (np.random.default_rng(3).standard_normal((1, 2 * 2048)) * 0.2).astype(np.float32)
    for i in range(2):
        state, _ = tts.encode_stream(cv.tokenizer_params, J_PACKED, state,
                                     torch.from_numpy(wav[:, i * 2048 : (i + 1) * 2048]), consts)
    assert len(seen) == 2 and all(u is units for u in seen) and len(calls) == 1
