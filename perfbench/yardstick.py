"""The benchmark's frozen yardstick: peaks, operation and byte counts, and
the device-busy arithmetic. Later changes to the program do not move these.

Origins (copied, then frozen here):
- `bound`, `layer_weight_bytes`, `distinct_rows`, `decode_bound`,
  `lstm_flops`: chip_smoke.py:402-452 (the kernel-table bounds).
- `analytic_train_flop_parts`: bench.py:41-88 (one ASR_ST step's matmul
  FLOPs by component), with an optional per-row frame count for the
  pyramid, an MT subset (`mt_train_flop_parts`) and a beam-decode count
  (`decode_flop_parts`) added here.
- `busy_union_ms`: stjep_tpu_torch/utils/trace_tools.py:102-111.

The peaks are the H100 SXM data sheet's at 700 W. The benchmark divides by
the float32 peak (the port's kernels and its float32 matmuls with TF32 off
use no tensor cores) and reports the card's power limit beside it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12}


def bound(n_bytes, flops, peak="f32", bf16_flops=0) -> Dict:
    """bound_ms, the larger of bytes over HBM bandwidth and operations
    over the peak of their type, and which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / PEAK[peak] + bf16_flops / PEAK["bf16"]
    return dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations")


def layer_weight_bytes(D: int, FF: int, quant: bool = False) -> int:
    """One decoder layer's streamed bytes: 6 D x D and 2 D x FF matrices
    (f32, or int8 with f32 scales per column), LayerNorms and FFN biases."""
    cols, small = 7 * D + FF, 4 * (6 * D + FF + D)
    mats = 6 * D * D + 2 * D * FF
    return (mats + 4 * cols if quant else 4 * mats) + small


def distinct_rows(anc, K: int, pos: int) -> int:
    """The distinct self-cache rows below pos that the ancestry anc [Lpad,
    BK] (a host integer array) reads: slot anc[l, r] of batch entry r // K
    at position l."""
    import numpy as np

    anc = np.asarray(anc)[:pos].astype(np.int64)
    BK = anc.shape[1]
    Bn = BK // K
    b = np.arange(BK) // K
    keys = anc * Bn + b + np.arange(pos)[:, None] * K * Bn
    return int(np.unique(keys).size)


def decode_bound(D: int, FF: int, nl: int, BK: int, K: int, pos: int, rows: int,
                 mem_rows: int, mem_mask_numel: int, cache_itemsize: int = 4,
                 quant: bool = False, V: int = 0, topk: int = 0) -> Tuple[int, int]:
    """Bytes and operations that nl decode layers at `pos` must spend (K5;
    with V, the head after them: K3), counted from the call's data: `rows`
    distinct self-cache rows the ancestry reads below pos, the new rows
    written, the `mem_rows` valid memory rows, the weights once; the
    layers' products, both attentions, and the head's product."""
    per_layer = (layer_weight_bytes(D, FF, quant)
                 + (2 * rows + 2 * BK + 2 * mem_rows) * D * cache_itemsize)
    n_bytes = nl * per_layer + 4 * BK * D + 8 * (pos + 1) * BK + 4 * mem_mask_numel
    flops = nl * (2 * BK * (6 * D * D + 2 * D * FF) + 4 * BK * (pos + 1) * D
                  + 4 * K * mem_rows * D)
    if V:
        n_bytes += 4 * (2 * D + D * V) + 8 * BK * topk
        flops += 2 * BK * D * V
    return n_bytes, flops


def megastep_bound(D: int, FF: int, nl: int, BK: int, K: int, i: int, rows: int,
                   mem_rows: int, mem_mask_numel: int, V: int, Lbuf: int,
                   cache_itemsize: int = 4) -> Tuple[int, int]:
    """The fused beam step K4 at position i (chip_smoke.py phase_k4's
    count): decode_bound of every layer and the head at position i - 1,
    plus the token rows and the time signal in and the select's state in
    and out (preds [BK, Lbuf], anc and maskk [Lbuf, BK] int32; last token,
    scores, eos, lenm [BK]; the flag)."""
    n_bytes, flops = decode_bound(D, FF, nl, BK, K, i - 1, rows, mem_rows, mem_mask_numel,
                                  cache_itemsize, False, V, K)
    state = 4 * (3 * BK * Lbuf + 4 * BK + 1)
    return n_bytes + 4 * BK * D + 4 * D + 2 * state, flops


def lstm_flops(lens: Iterable[int], din: int, H: int) -> int:
    """Both directions' input and recurrent products over the valid frames."""
    return 2 * int(sum(int(x) for x in lens)) * (2 * din * 4 * H + 2 * H * 4 * H)


def pyramid_lens(lens: Sequence[int], T: int, layers: int):
    """The valid frames of each pyramid layer: round_up8 (x + 8 - x % 8)
    capped at T, then halved between layers (models/las_encoder.py)."""
    cur = [min(int(x) + 8 - int(x) % 8, T) for x in lens]
    out = []
    for _ in range(layers):
        out.append(cur)
        cur = [x // 2 for x in cur]
    return out


def bilstm_train_work(lens: Sequence[int], T: int, din0: int, H: int,
                      layers: int) -> Tuple[int, int]:
    """Bytes and operations of the trainable pyramid's K8 kernels in one
    step, forward and backward: the forward's input and recurrent products
    (the port's GEMM and sweep), the backward sweep's recurrent product
    (dPre -> dh; the weight and input gradients are library matmuls, timed
    and counted elsewhere). Bytes: each layer's input, weights and output
    cotangent read once, its output and dPre stream written once, at the
    padded shapes the kernels take."""
    B = len(lens)
    n_bytes, flops, t, din = 0, 0, T, din0
    for lay in pyramid_lens(lens, T, layers):
        flops += lstm_flops(lay, din, H) + 2 * sum(lay) * 2 * H * 4 * H
        weights = 2 * 4 * (din * 4 * H + H * 4 * H + 2 * 4 * H)
        n_bytes += 4 * B * t * din + weights + 4 * B * t * 2 * H * 2 + 4 * 2 * t * B * 4 * H
        t, din = t // 2, 4 * H
    return n_bytes, flops


def analytic_train_flop_parts(cfg, B: int, T: int, Ls: int, Lt: int,
                              lens: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Per-component analytic matmul FLOPs of one ASR_ST train step
    (fwd+bwd+apply), as a dict. Counts matmul MACs x 2 (elementwise and
    softmax ignored), backward ~= 2x forward, so train = 3x forward.
    `lens` (a row's frames): the pyramid counts each row's valid frames
    (`pyramid_lens`) instead of T for every row."""
    H = cfg["acous_hidden_size"]
    D = cfg["dim_model"]
    F = cfg["dim_feedforward"]
    E = cfg["enc_embedding_size"]
    Ve = cfg["enc_vocab_size"]
    Vd = cfg["dec_vocab_size"]
    parts = {}
    # pyramidal BiLSTM: per step/direction (in*4H + H*4H) MACs; input doubles
    # (concat adjacent pairs of the 2H output) while T halves each layer
    t, d = T, cfg["acous_dim"]
    layer_lens = pyramid_lens(lens, T, cfg["num_pyramid_layers"]) if lens is not None else None
    macs = 0.0
    for li in range(cfg["num_pyramid_layers"]):
        frames = sum(layer_lens[li]) if layer_lens is not None else t * B
        macs += 2 * frames * (d * 4 * H + H * 4 * H)  # x2 directions
        t //= 2
        d = 4 * H
    parts["pyramid"] = macs
    Tk = T // 8
    # LAS decoder: Ls-1 steps of 3-layer LSTM + bilinear att + FFN + out proj
    steps = Ls - 1
    lstm = (E + D) * 4 * D + D * 4 * D + 2 * (2 * D * 4 * D)
    att = Tk * 2 * H * D / max(steps, 1) + Tk * D  # keys hoisted + per-step dot
    ffn = (2 * H + D) * D
    outp = D * Ve
    parts["las_decoder"] = steps * B * (lstm + att + ffn + outp)
    parts.update(_text_parts(cfg, B, Ls, Lt))
    # MACs -> FLOPs (x2), fwd+bwd+apply ~= 3x fwd
    return {k: 3.0 * 2.0 * v for k, v in parts.items()}


def _text_parts(cfg, B: int, Ls: int, Lt: int) -> Dict[str, float]:
    """MACs of the source projection, the transformer encoder over Ls - 1
    positions, the decoder over Lt and its vocabulary head (bench.py)."""
    D, F = cfg["dim_model"], cfg["dim_feedforward"]
    E, Vd = cfg["enc_embedding_size"], cfg["dec_vocab_size"]
    Lse = Ls - 1
    return {
        "src_emb_proj": B * Lse * (E + D) * D,
        "tf_encoder": cfg["enc_layers"] * B * (Lse * (4 * D * D + 2 * D * F) + 2 * Lse * Lse * D),
        "tf_decoder": cfg["dec_layers"] * B * (
            Lt * (4 * D * D + 2 * D * F) + 2 * Lt * Lt * D
            + Lt * 2 * D * D + Lse * 2 * D * D + 2 * Lt * Lse * D),
        "st_head": B * Lt * D * Vd,
    }


def mt_train_flop_parts(cfg, B: int, Ls: int, Lt: int) -> Dict[str, float]:
    """One MT train step: analytic_train_flop_parts without the LAS (the
    source projection, encoder, decoder and head), train = 3x forward."""
    return {k: 6.0 * v for k, v in _text_parts(cfg, B, Ls, Lt).items()}


def decode_flop_parts(cfg, lens: Sequence[int], T: int, las_steps: int, Lk: int,
                      positions: int, K: int, mem_rows: int) -> Dict[str, float]:
    """Forward FLOPs of one ST beam decode batch: the pyramid over each
    row's valid frames, `las_steps` steps of the LAS decoder for every row
    (three LSTMs, bilinear attention over T/8 keys with the keys' projection
    once, the FFN and the vocabulary head), the source projection and the
    encoder over Lk positions, the memory's K/V projections once per layer,
    then `positions` beam positions of B*K rows (each layer's products and
    attentions over the position's prefix and the `mem_rows` valid memory
    rows, and the head)."""
    H, D, F = cfg["acous_hidden_size"], cfg["dim_model"], cfg["dim_feedforward"]
    E, Ve, Vd = cfg["enc_embedding_size"], cfg["enc_vocab_size"], cfg["dec_vocab_size"]
    B, nl = len(lens), cfg["dec_layers"]
    parts = {}
    d = cfg["acous_dim"]
    pyr = 0
    for lay in pyramid_lens(lens, T, cfg["num_pyramid_layers"]):
        pyr += lstm_flops(lay, d, H)
        d = 4 * H
    parts["pyramid"] = pyr
    Tk = T // 8
    lstm = (E + D) * 4 * D + D * 4 * D + 2 * (2 * D * 4 * D)
    parts["las_decoder"] = 2 * B * (Tk * 2 * H * D + las_steps * (
        lstm + Tk * D + Tk * 2 * H + (2 * H + D) * D + D * Ve))
    text = _text_parts(cfg, B, Lk + 1, 0)
    parts["src_emb_proj"] = 2 * text["src_emb_proj"]
    parts["tf_encoder"] = 2 * text["tf_encoder"]
    BK = B * K
    per_pos = nl * BK * (6 * D * D + 2 * D * F) + BK * D * Vd
    attn = sum(nl * (2 * BK * (p + 1) * D + 2 * K * mem_rows * D) for p in range(positions))
    parts["tf_decoder"] = 2 * (nl * B * Lk * 2 * D * D + positions * per_pos + attn)
    return parts


def busy_union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total / 1e3
