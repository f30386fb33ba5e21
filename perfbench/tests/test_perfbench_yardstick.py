"""The frozen arithmetic against hand counts at small shapes."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import yardstick as y

CFG = dict(acous_hidden_size=1, dim_model=2, dim_feedforward=3, enc_embedding_size=1,
           enc_vocab_size=5, dec_vocab_size=7, acous_dim=2, num_pyramid_layers=2,
           enc_layers=1, dec_layers=1)


def test_bound_picks_the_larger_side():
    assert y.bound(3.35e9, 1.0) == {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
    assert y.bound(1.0, 2 * 67e9) == {"bound_ms": pytest.approx(2.0), "bound_by": "operations"}


def test_layer_weight_bytes():
    # D 4, FF 8: 6*16 + 2*32 = 160 floats of matrices, 4*(24 + 8 + 4) bytes of the rest
    assert y.layer_weight_bytes(4, 8) == 640 + 144
    assert y.layer_weight_bytes(4, 8, quant=True) == 160 + 4 * (28 + 8) + 144


def test_distinct_rows():
    # B = 1, K = 2: at position 0 both rows read slot 0, at position 1 slots 0 and 1
    anc = np.array([[0, 0], [0, 1], [5, 5]])
    assert y.distinct_rows(anc, 2, 2) == 3
    assert y.distinct_rows(anc, 2, 1) == 1


def test_decode_bound_by_hand():
    D, FF, BK, K, pos, rows, mem_rows, numel = 2, 3, 2, 2, 3, 4, 5, 8
    n_bytes, flops = y.decode_bound(D, FF, 1, BK, K, pos, rows, mem_rows, numel)
    weights = 4 * (6 * 4 + 2 * 6) + 4 * (12 + 3 + 2)
    caches = (2 * 4 + 2 * 2 + 2 * 5) * 2 * 4
    assert n_bytes == weights + caches + 4 * 2 * 2 + 8 * 4 * 2 + 4 * 8
    assert flops == 2 * 2 * (24 + 12) + 4 * 2 * 4 * 2 + 4 * 2 * 5 * 2
    nb2, fl2 = y.decode_bound(D, FF, 1, BK, K, pos, rows, mem_rows, numel, V=7, topk=2)
    assert (nb2 - n_bytes, fl2 - flops) == (4 * (4 + 14) + 8 * 2 * 2, 2 * 2 * 2 * 7)


def test_megastep_adds_the_state():
    args = (2, 3, 6, 2, 2, 4, 4, 5, 8, 7, 16)
    nb, fl = y.megastep_bound(*args)
    nb0, fl0 = y.decode_bound(2, 3, 6, 2, 2, 3, 4, 5, 8, 4, False, 7, 2)
    assert fl == fl0 and nb - nb0 == 4 * 2 * 2 + 4 * 2 + 2 * 4 * (3 * 2 * 16 + 4 * 2 + 1)


def test_lstm_flops_and_pyramid_lens():
    assert y.lstm_flops([3, 5], 2, 1) == 2 * 8 * (2 * 2 * 4 + 2 * 1 * 4)
    assert y.pyramid_lens([8, 13], 24, 3) == [[16, 16], [8, 8], [4, 4]]
    assert y.pyramid_lens([23], 24, 1) == [[24]]


def test_train_flops_by_hand():
    B, T, Ls, Lt = 1, 8, 3, 2
    got = y.analytic_train_flop_parts(CFG, B, T, Ls, Lt)
    H, D, F, E = 1, 2, 3, 1
    pyr = 2 * 8 * (2 * 4 + 4) + 2 * 4 * (4 * 4 + 4)
    lstm = (E + D) * 4 * D + D * 4 * D + 2 * (2 * D * 4 * D)
    las = 2 * (lstm + 1 * 2 * H * D / 2 + 1 * D + (2 * H + D) * D + D * 5)
    enc = 2 * (4 * D * D + 2 * D * F) + 2 * 4 * D
    dec = 2 * (4 * D * D + 2 * D * F) + 2 * 4 * D + 2 * 2 * D * D + 2 * 2 * D * D + 2 * 2 * 2 * D
    want = {"pyramid": pyr, "las_decoder": las, "src_emb_proj": 2 * (E + D) * D,
            "tf_encoder": enc, "tf_decoder": dec, "st_head": 2 * D * 7}
    assert got == {k: pytest.approx(6 * v) for k, v in want.items()}
    with_lens = y.analytic_train_flop_parts(CFG, B, T, Ls, Lt, lens=[3])
    # round_up8(3) = 8 frames in layer 1, 4 in layer 2: the padded count again
    assert with_lens["pyramid"] == got["pyramid"]
    mt = y.mt_train_flop_parts(CFG, B, Ls, Lt)
    assert set(mt) == {"src_emb_proj", "tf_encoder", "tf_decoder", "st_head"}
    assert all(mt[k] == pytest.approx(got[k]) for k in mt)


def test_decode_flops_by_hand():
    parts = y.decode_flop_parts(CFG, [8], 16, las_steps=2, Lk=2, positions=2, K=2, mem_rows=2)
    H, D, F, E = 1, 2, 3, 1
    assert parts["pyramid"] == y.lstm_flops([16], 2, 1) + y.lstm_flops([8], 4, 1)
    lstm = (E + D) * 4 * D + D * 4 * D + 2 * (2 * D * 4 * D)
    Tk = 2
    assert parts["las_decoder"] == 2 * (Tk * 2 * H * D + 2 * (lstm + Tk * D + Tk * 2 * H
                                                              + (2 * H + D) * D + D * 5))
    per_pos = 2 * (6 * D * D + 2 * D * F) + 2 * D * 7
    attn = sum(2 * 2 * (p + 1) * D + 2 * 2 * 2 * D for p in range(2))
    assert parts["tf_decoder"] == 2 * (2 * 2 * D * D + 2 * per_pos + attn)


def test_busy_union():
    assert y.busy_union_ms([(0, 1000), (500, 1500), (3000, 4000)]) == pytest.approx(2.5)
    assert y.busy_union_ms([]) == 0.0
