"""The roofline counts: hand-worked values at a tiny geometry, and no
dependence on what the program allocates (cache rows, max_seq_len)."""

import copy

import pytest

from portbench import core, counts

FULL = core.load_json(core.ROOT / "configs" / "sva-convert.json")["pipeline"]

TINY_LM = {"vocab_size": 16, "n_layer": 2, "n_head": 2, "n_local_heads": 2, "dim": 8,
           "intermediate_size": 12, "head_dim": 4, "max_seq_len": 64, "codebook_size": 10,
           "num_codebooks": 3, "n_fast_layer": 1, "fast_dim": 8, "fast_n_head": 2,
           "fast_n_local_heads": 2, "fast_head_dim": 4, "fast_intermediate_size": 12}


def test_slow_step_by_hand():
    # a layer: wqkv 8x24 + wo 8x8 + w1, w3 8x12 + w2 12x8 = 192 + 64 + 288 = 544
    # ops: 2 rows x 2 layers x 2 x 544 = 4352; attention: rows 5 + 6 attended,
    # 2 layers x 4 x 11 x 8 = 704; head 2 x 8 x 16 = 256
    ops, nbytes = counts.slow_step(TINY_LM, pos=4, wb=2, cb=4)
    assert ops == 4352 + 704 + 256
    # weights 2 x 544 x 2 B = 2176; cache rows < 6: 4 B x 2 layers x 2 x 8 x 6 = 768;
    # inputs 2 B x 2 x 2 x 8 = 64; head 2 B x 128 = 256 and noise 4 B x 16 = 64
    assert nbytes == 2176 + 768 + 64 + 256 + 64


def test_fast_loop_by_hand():
    # layer 544; 3 steps x 2 x (544 + 8 x 10) = 3744; attention 1 x 4 x 8 x (1+2+3) = 192
    ops, nbytes = counts.fast_loop(TINY_LM, wb=2)
    assert ops == 3744 + 192
    # weights 2 x (544 + 80) = 1248; fast embeddings 2 rows x 8 x 2 = 32;
    # codebook embeddings 3 x 8 x 2 = 48; noise 4 x 3 x 10 = 120
    assert nbytes == 1248 + 32 + 48 + 120


def test_ring_step_by_hand():
    t = {"n_layer": 1, "dim": 4, "intermediate_size": 6, "n_head": 1, "head_dim": 4,
         "window_size": 3}
    # a layer: 4 x 12 + 4 x 4 + 3 x 4 x 6 = 136; ops 2 x 136 + 4 x 4 x (3 + 1)
    ops, nbytes = counts.ring_step(t, count=10, wb=4, sb=2)
    assert ops == 272 + 64
    assert nbytes == 4 * 136 + 2 * 2 * 4 * 4


def test_head_matches_its_operation_count():
    # the published head at 4 input rows: 2,623,227,904 operations
    ops, _ = counts.head(FULL["vocoder"]["head"], 4, 4)
    assert ops == 2623227904


@pytest.mark.parametrize("rows", [1024, 2048, 4096])
def test_counts_ignore_allocated_rows(rows):
    d = copy.deepcopy(FULL["arvc"]["decoder"])
    base = (counts.slow_step(d, 1000, 2, 2), counts.fast_loop(d, 2))
    d["max_seq_len"] = rows
    assert (counts.slow_step(d, 1000, 2, 2), counts.fast_loop(d, 2)) == base


def test_least_time_takes_the_larger_bound():
    assert counts.least_s((989e12, 0.0), "bfloat16") == pytest.approx(1.0)
    assert counts.least_s((0.0, 3.35e12), "float32") == pytest.approx(1.0)
    assert counts.least_s((67e12, 3.35e12 / 2), "float32") == pytest.approx(1.0)
