"""K3 - K7: transformer decode-step kernels (port of
stjep_tpu/ops/decode_flash.py `decoder_layer_step_flash`, `self_attn_step`,
`cross_attn_step`, `ffn_step`, `decode_head`, `decode_head_gather`,
`decode_head_partial`, `decode_chain_step_flash` and
`decode_beam_step_flash`).

K5 runs one decode position through one decoder layer. K6a-c are that step
as three launches (self-attention, cross-attention, FFN), which also take a
tensor-parallel shard's rectangular weights and return its partial without
the residual; `decoder_layer_step_flash_trio` composes them into K5. K7 is
the decode head: final LayerNorm, output projection, log-softmax and top-K,
and with gather ids the log-prob at a reference id; K7c is one vocabulary
shard of it (raw top-K logits, row max and sum-exp). K3 runs one position
through every layer (K5 per layer) and the head (K7). K4 is the whole beam
while-body: embed + time signal, the layers, the head, and the k^2 -> k
select with its back-copies; `beam_select` is that select alone, for the
general beam loop. On the card K5 and K4 are one cooperative launch each
(`csrc/decode_fused.cu`; from the shapes alone, `fused_tiles` gives the
tile table they walk and `fused_plan` their phases, barriers, shared memory
and workspace); the other kernels' design
notes are in `csrc/decode.cu`; the tensor-parallel layer step and head are
in `ops/decode_flash_tp.py`.

Layouts are the JAX kernels': self caches [K, B, Lpad, D] per layer
([nl, K, B, Lpad, D] stacked for K3/K4), never reordered, read through the
ancestry map anc [Lpad, B*K] (row r reads position l from slot
(anc[l, r], r // K)); memory K/V [B, Lk_pad, D] per layer; masks transposed
(maskk [Lpad, B*K], mem_mask [Lk_pad, B]) and int32. Every route updates
the caches in place (the new K/V row at `pos`), and K4 also sets anc[pos]
to each row's own slot in place. Hidden states are [B*K, D].

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the `_plain` versions, which compute the same function in PyTorch, with the
same ancestry semantics, in the order of the JAX package's dense XLA path.

Two serving options, as in the JAX kernels, in any combination:
- int8 weights (`quantize_decoder_weights`, JAX `_layer_kernel_q8` and
  `quant=True`): the eight matrices a layer streams per position are int8
  with one f32 scale per output column; `layer_weights` and
  `stack_decoder_layers` return (tensors, quant), and every layer step
  dequantizes per matrix: the plain versions in PyTorch, the fused kernels
  as each weight tile is read. Biases, LayerNorms, the cross K/V
  projections and the head stay f32.
- bf16 caches: self caches and memory K/V in bfloat16 (each stream's own
  dtype selects its attention kernel), rounded where the JAX cores round
  (`self_attn_anc_plain`, `cross_attn_plain`, `csrc/decode.cu`).
Each wrapper counts its launches per variant: `launches` (f32 weights and
caches), `q8_launches`, `bf16_launches`, `q8_bf16_launches`, and for K3's
gather variant the same names after `gather_`. K6a-c and K7c take f32
weights only (the tensor-parallel trio has no dequantizing path, as in
JAX); K6a and K6b count `launches` and `bf16_launches` by cache dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.bridge import leaves
from stjep_tpu_torch.config import EOS, PAD
from stjep_tpu_torch.ops.transformer import ATTN_MASK_FILL as NEG
from stjep_tpu_torch.ops.transformer import layer_norm

BLOCK = 16  # self-cache length is padded to a multiple of this
# what to differentiate through instead of K3-K7 (their CUDA routes have no backward)
TRAINABLE = "the full-sequence decoder (models/tf_decoder.py tf_decoder_forward)"
CROSS_BLOCK = 32  # memory length is padded to a multiple of this

CHAIN_KEYS = (
    ("decslf_attn", "layer_norm", "scale"), ("decslf_attn", "layer_norm", "bias"),
    ("decslf_attn", "w_qs", "w"), ("decslf_attn", "w_ks", "w"),
    ("decslf_attn", "w_vs", "w"), ("decslf_attn", "fc", "w"),
    ("encdec_attn", "layer_norm", "scale"), ("encdec_attn", "layer_norm", "bias"),
    ("encdec_attn", "w_qs", "w"), ("encdec_attn", "fc", "w"),
    ("pos_ffn", "layer_norm", "scale"), ("pos_ffn", "layer_norm", "bias"),
    ("pos_ffn", "w_1", "w"), ("pos_ffn", "w_1", "b"),
    ("pos_ffn", "w_2", "w"), ("pos_ffn", "w_2", "b"),
)
CHAIN_KEYS_Q8 = (
    ("decslf_attn", "layer_norm", "scale"), ("decslf_attn", "layer_norm", "bias"),
    ("decslf_attn", "w_qs", "w"), ("decslf_attn", "w_qs", "w_s"),
    ("decslf_attn", "w_ks", "w"), ("decslf_attn", "w_ks", "w_s"),
    ("decslf_attn", "w_vs", "w"), ("decslf_attn", "w_vs", "w_s"),
    ("decslf_attn", "fc", "w"), ("decslf_attn", "fc", "w_s"),
    ("encdec_attn", "layer_norm", "scale"), ("encdec_attn", "layer_norm", "bias"),
    ("encdec_attn", "w_qs", "w"), ("encdec_attn", "w_qs", "w_s"),
    ("encdec_attn", "fc", "w"), ("encdec_attn", "fc", "w_s"),
    ("pos_ffn", "layer_norm", "scale"), ("pos_ffn", "layer_norm", "bias"),
    ("pos_ffn", "w_1", "w"), ("pos_ffn", "w_1", "w_s"), ("pos_ffn", "w_1", "b"),
    ("pos_ffn", "w_2", "w"), ("pos_ffn", "w_2", "w_s"), ("pos_ffn", "w_2", "b"),
)
QUANT_SELF = ("w_qs", "w_ks", "w_vs", "fc")
QUANT_CROSS = ("w_qs", "fc")
QUANT_FFN = ("w_1", "w_2")
CACHE_DTYPES = (torch.float32, torch.bfloat16)


def pad_len(n: int, block: int = BLOCK) -> int:
    return ((n + block - 1) // block) * block


def _q8_leaf(leaf: Dict) -> Dict:
    """{"w": [in, out]} -> {"w": int8, "w_s": f32 [1, out]}: symmetric per
    output column, s = max|w| / 127 (1 for an all-zero column), q =
    clip(round(w / s), -127, 127), ties to even as jnp.round."""
    w = leaf["w"].to(torch.float32)
    s = w.abs().amax(dim=0, keepdim=True) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    out = dict(leaf)
    out["w"] = torch.clamp(torch.round(w / s), -127.0, 127.0).to(torch.int8)
    out["w_s"] = s
    return out


def quantize_decoder_weights(dec_params: Dict) -> Dict:
    """A copy of the decoder tree (`dec_tgt`) whose streamed matrices (self
    q/k/v/o, cross q/o, FFN w_1/w_2) are int8 with per-column scales; the
    other leaves (LayerNorms, biases, the cross K/V projections, the final
    norm) are shared. The layer steps detect the "w_s" key."""
    layers = []
    for lp in dec_params["layers"]:
        nl = dict(lp)
        for sub, keys in (("decslf_attn", QUANT_SELF), ("encdec_attn", QUANT_CROSS),
                          ("pos_ffn", QUANT_FFN)):
            nl[sub] = {**lp[sub], **{k: _q8_leaf(lp[sub][k]) for k in keys}}
        layers.append(nl)
    return {**dec_params, "layers": layers}


def layer_weights(lp: Dict) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """One decoder layer's weights, in CHAIN_KEYS order (CHAIN_KEYS_Q8 for
    a quantize_decoder_weights'd layer), and whether it is quantized."""
    quant = "w_s" in lp["decslf_attn"]["w_qs"]
    out = []
    for path in CHAIN_KEYS_Q8 if quant else CHAIN_KEYS:
        t = lp
        for key in path:
            t = t[key]
        out.append(t)
    return tuple(out), quant


def stack_decoder_layers(dec_params: Dict) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """Each per-layer weight stacked into one contiguous [nl, ...] tensor,
    in layer_weights' order; returns (stacked tensors, quantized?), the pair
    K3 and K4 take as `stacked`."""
    per_layer = [layer_weights(lp) for lp in dec_params["layers"]]
    quant = per_layer[0][1]
    return (tuple(torch.stack(ts, 0).contiguous() for ts in zip(*(w for w, _ in per_layer))),
            quant)


# CHAIN_KEYS positions of the eight streamed matrices
_MATS = (2, 3, 4, 5, 8, 9, 12, 14)


def _pairs(w, quant: bool):
    """Weights in CHAIN_KEYS(_Q8) order -> CHAIN_KEYS order with each
    streamed matrix as a pair (w, w_s), w_s None for f32 (JAX
    `_chain_unpack`)."""
    if quant:
        return (w[0], w[1], w[2:4], w[4:6], w[6:8], w[8:10], w[10], w[11],
                w[12:14], w[14:16], w[16], w[17], w[18:20], w[20], w[21:23], w[23])
    return tuple((t, None) if i in _MATS else t for i, t in enumerate(w))


def _variant(quant: bool, cache: torch.Tensor) -> str:
    return ("q8_" if quant else "") + ("bf16_" if cache.dtype == torch.bfloat16 else "")


def _count(fn, variant: str):
    name = variant + "launches"
    setattr(fn, name, getattr(fn, name) + 1)


def _init_counts(fn, variants, prefixes=("",)):
    for p in prefixes:
        for v in variants:
            setattr(fn, p + v + "launches", 0)


VARIANTS = ("", "q8_", "bf16_", "q8_bf16_")


def _ln(x, scale, bias, eps):
    return layer_norm({"scale": scale, "bias": bias}, x, eps)


def _mm(x, m):
    """x @ the matrix of a (w, w_s) pair, dequantized as JAX's `dq`."""
    w, s = m
    return x @ (w if s is None else w.to(torch.float32) * s)


def _attend_plain(q, k, v, valid, n_head):
    """q [BK, D] f32; k, v [BK, L, D] in the cache dtype; valid [BK, L] bool
    -> [BK, D] f32. With bf16 k and v the scaled query is rounded to bf16
    and each q.k product too before the f32 head sum; p.v sums in f32."""
    BK, L, D = k.shape
    d = D // n_head
    qh = q.view(BK, n_head, d) / (d ** 0.5)
    if k.dtype == torch.float32:
        s = torch.einsum("rnd,rlnd->rnl", qh, k.view(BK, L, n_head, d))
    else:
        prod = qh.to(k.dtype)[:, None] * k.view(BK, L, n_head, d)
        s = prod.float().sum(-1).transpose(1, 2)
    s = s.masked_fill(~valid[:, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rnl,rlnd->rnd", p,
                        v.float().view(BK, L, n_head, d)).reshape(BK, D)


def self_attn_anc_plain(q, k_new, v_new, cache_k, cache_v, anc, self_mask_k,
                        pos: int, group: int, n_head: int):
    """Self-attention at `pos` through the ancestry map: q, k_new, v_new
    [BK, D] f32 (q unscaled) from the layer's projections; the new K/V row
    goes into each row's own slot of cache_k/v [K, B, Lpad, D] at `pos`,
    rounded to the cache dtype, and row r reads position l from slot
    (anc[l, r], r // K). Returns the context [BK, D] f32, before the output
    projection."""
    BK = q.shape[0]
    row = torch.arange(BK, device=q.device)
    own, b = row % group, row // group
    cache_k[own, b, pos] = k_new.to(cache_k.dtype)
    cache_v[own, b, pos] = v_new.to(cache_v.dtype)
    lidx = torch.arange(pos + 1, device=q.device)
    ancp = anc[:pos + 1].T.long()  # [BK, pos+1]
    ksel = cache_k[ancp, b[:, None], lidx[None, :]]  # [BK, pos+1, D]
    vsel = cache_v[ancp, b[:, None], lidx[None, :]]
    return _attend_plain(q, ksel, vsel, self_mask_k[:pos + 1].T != 0, n_head)


def cross_attn_plain(q, mem_k, mem_v, mem_mask, group: int, n_head: int):
    """Cross-attention of q [BK, D] f32 (unscaled) over the unexpanded
    memory mem_k/v [B, Lk_pad, D] (f32 or bf16) of row r's batch entry
    r // group; mem_mask [Lk_pad, B]. Returns the context [BK, D] f32."""
    b = torch.arange(q.shape[0], device=q.device) // group
    return _attend_plain(q, mem_k[b], mem_v[b], mem_mask.T[b] != 0, n_head)


def _self_attn_cuda(q, k_new, v_new, ck, cv, anc, maskk, pos, group, n_head):
    bf16 = ck.dtype == torch.bfloat16
    BK, D = q.shape
    att = torch.empty_like(q)
    kernels.launch("self_attn_anc_bf16" if bf16 else "self_attn_anc", q, k_new,
                   v_new, ck, cv, anc, maskk, att, pos, BK, group, ck.shape[2],
                   D, n_head)
    _count(self_attn_anc, "bf16_" if bf16 else "")
    return att


def _cross_attn_cuda(q, mk, mv, mem_mask, group, n_head):
    bf16 = mk.dtype == torch.bfloat16
    BK, D = q.shape
    att = torch.empty_like(q)
    kernels.launch("cross_attn_bf16" if bf16 else "cross_attn", q, mk, mv,
                   mem_mask, att, BK, group, mk.shape[1], D, n_head)
    _count(cross_attn, "bf16_" if bf16 else "")
    return att


def _check_streams(*pairs):
    """Each (a, b, name): two cache tensors of one dtype in CACHE_DTYPES."""
    for a, b, nm in pairs:
        if a.dtype not in CACHE_DTYPES:
            raise ValueError(f"{nm} must be float32 or bfloat16, got {a.dtype}")
        kernels.check(a, a.dtype, nm)
        kernels.check(b, a.dtype, nm)


def self_attn_anc(q, k_new, v_new, cache_k, cache_v, anc, self_mask_k,
                  pos: int, group: int, n_head: int):
    """The self-attention kernel of K5 alone, with self_attn_anc_plain's
    arguments and results; f32 or bf16 caches (`launches`,
    `bf16_launches`)."""
    if not q.is_cuda:
        return self_attn_anc_plain(q, k_new, v_new, cache_k, cache_v, anc,
                                   self_mask_k, pos, group, n_head)
    for t, nm in ((q, "q"), (k_new, "k_new"), (v_new, "v_new")):
        kernels.check(t, torch.float32, nm)
    _check_streams((cache_k, cache_v, "self caches"))
    for t, nm in ((anc, "anc"), (self_mask_k, "self_mask_k")):
        kernels.check(t, torch.int32, nm)
    return _self_attn_cuda(q, k_new, v_new, cache_k, cache_v, anc, self_mask_k,
                           pos, group, n_head)


def cross_attn(q, mem_k, mem_v, mem_mask, group: int, n_head: int):
    """The cross-attention kernel of K5 alone, with cross_attn_plain's
    arguments and results; f32 or bf16 memory (`launches`,
    `bf16_launches`)."""
    if not q.is_cuda:
        return cross_attn_plain(q, mem_k, mem_v, mem_mask, group, n_head)
    kernels.check(q, torch.float32, "q")
    _check_streams((mem_k, mem_v, "memory K/V"))
    kernels.check(mem_mask, torch.int32, "mem_mask")
    return _cross_attn_cuda(q, mem_k, mem_v, mem_mask, group, n_head)


_init_counts(self_attn_anc, ("", "bf16_"))
_init_counts(cross_attn, ("", "bf16_"))


def _layer_plain(w, quant, x, ck, cv, mk, mv, pos, n_head, anc, group,
                 mem_mask, maskk):
    """One layer at `pos` in plain PyTorch: w in layer_weights' order,
    caches ck/cv [K, B, Lpad, D], memory mk/mv [B, Lk_pad, D]."""
    (slns, slnb, swq, swk, swv, swo, clns, clnb, cwq, cwo,
     flns, flnb, w1, b1, w2, b2) = _pairs(w, quant)
    q = _mm(_ln(x, slns, slnb, 1e-6), swq)
    att = self_attn_anc_plain(q, _mm(x, swk), _mm(x, swv), ck, cv, anc, maskk,
                              pos, group, n_head)
    x = _mm(att, swo) + x
    q = _mm(_ln(x, clns, clnb, 1e-6), cwq)
    x = _mm(cross_attn_plain(q, mk, mv, mem_mask, group, n_head), cwo) + x
    h = torch.relu(_mm(_ln(x, flns, flnb, 1e-6), w1) + b1)
    return _mm(h, w2) + b2 + x


# ---------------------------------------------------------------------------
# K5 and K4 on the card: csrc/decode_fused.cu, one cooperative launch each
# ---------------------------------------------------------------------------

FUSED_KC = 64  # contraction depth of a product tile (decode_fused.cu KC)
FUSED_BM, FUSED_BN = 16, 128  # rows and columns of a product tile
FUSED_THREADS = 256
# blocks of a fused launch; 0 launches every block the card keeps resident
# (the card tests set it to hold the outputs independent of the grid)
FUSED_GRID = 0
# the product kinds of the tile table, in decode_fused.cu's order (P_QKV ..)
FUSED_PRODUCTS = ("qkv", "fc", "cq", "co", "w1", "w2", "head")


def gemm_tiles(M: int, N: int, Kd: int):
    """The tiles of one product [M, Kd] @ [Kd, N] of the fused kernels
    (column tile fastest, then row tile, then split): (split, first row,
    first column); split s sums k in [s*KC, (s+1)*KC)."""
    ct, rt, s = -(-N // FUSED_BN), -(-M // FUSED_BM), -(-Kd // FUSED_KC)
    return [(t // (ct * rt), (t // ct) % rt * FUSED_BM, t % ct * FUSED_BN)
            for t in range(s * rt * ct)]


def _products(BK: int, D: int, FF: int, V: int = 0) -> Dict:
    """{kind: [(M, N, Kd) per job]}, the jobs in decode_fused.cu
    `layer_jobs` order (q, k, v for qkv); the head only with V."""
    out = {"qkv": [(BK, D, D)] * 3, "fc": [(BK, D, D)], "cq": [(BK, D, D)],
           "co": [(BK, D, D)], "w1": [(BK, FF, D)], "w2": [(BK, D, FF)]}
    if V:
        out["head"] = [(BK, V, D)]
    return out


def fused_tiles(BK: int, D: int, FF: int, V: int = 0) -> torch.Tensor:
    """The tile table the fused kernels walk (`tiles`, decode_fused.cu
    `phase`): int32, 8 offsets (the first tile of each kind of
    FUSED_PRODUCTS, then the end), then one row (job, split, first row,
    first column) per tile, a kind's jobs one after another."""
    prods = _products(BK, D, FF, V)
    rows, off = [], []
    for kind in FUSED_PRODUCTS:
        off.append(len(rows))
        for j, (M, N, Kd) in enumerate(prods.get(kind, [])):
            rows += [(j, s, r0, c0) for s, r0, c0 in gemm_tiles(M, N, Kd)]
    off.append(len(rows))
    return torch.tensor(off + [v for row in rows for v in row], dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _tiles_on(device, BK: int, D: int, FF: int, V: int) -> torch.Tensor:
    return fused_tiles(BK, D, FF, V).to(device)


@functools.lru_cache(maxsize=128)
def fused_plan(BK: int, D: int, FF: int, n_head: int, Lpad: int, Lk: int,
               quant: bool = False, beam: bool = False, nl: int = 1, V: int = 0,
               K: int = 1) -> Dict:
    """The launch of fused K5 (one layer) or, with beam, fused K4 (nl
    layers, the head over V ids and the select of B = BK / K groups), from
    the shapes alone: `products` {kind: [(M, N, Kd)]} per product job,
    `phases` [(kind, work items)] in order (a product phase's items are its
    tiles, an attention's (row, head) pairs, a row or top-K phase's rows,
    the select's groups), `barriers` (grid barriers a launch), `smem`
    (dynamic shared bytes a block) and `ws_floats` (f32 workspace); the
    kernels walk `fused_tiles` of the same shapes. Cached: the wrappers ask
    it at every launch; treat the result as read-only."""
    products = _products(BK, D, FF, V if beam else 0)
    tiles = {k: sum(len(gemm_tiles(*job)) for job in jobs) for k, jobs in products.items()}
    att = BK * n_head
    body = [("qkv", tiles["qkv"]), ("self", att), ("fc", tiles["fc"]), ("row", BK),
            ("cq", tiles["cq"]), ("cross", att), ("co", tiles["co"]), ("row", BK),
            ("w1", tiles["w1"]), ("w2", tiles["w2"]), ("row", BK)]
    if beam:
        phases = [("embed", BK)] + body * nl + [("head", tiles["head"]), ("topk", BK),
                                                 ("select", BK // K)]
    else:
        phases = [("row", BK)] + body
    kc = FUSED_KC
    sd, sf = -(-D // kc), -(-FF // kc)
    wbytes = 4 if beam or not quant else 1
    d = D // n_head
    smem = max(2 * (kc * FUSED_BN * wbytes + kc * FUSED_BM * 4),
               FUSED_THREADS // 32 * (d + 3 * max(Lpad, Lk)) * 4)
    pa = max(3 * sd * BK * D, sd * BK * FF, sd * BK * V)
    ws = 5 * BK * D + pa + max(sd, sf) * BK * D + BK * V + 2 * BK * K
    return dict(products=products, phases=phases, barriers=len(phases) - 1, smem=smem,
                ws_floats=ws)


def fused_grid(quant: bool, bf16: bool, beam: bool, smem: int) -> Dict[str, int]:
    """The card's answer for a fused launch at smem bytes: blocks an SM
    keeps resident and the SM count (their product is the grid)."""
    out = (ctypes.c_int * 2)()
    kernels.launch("decode_fused_grid", int(quant), int(bf16), int(beam), smem,
                   ctypes.addressof(out))
    return dict(blocks_per_sm=out[0], sms=out[1], blocks=out[0] * out[1])


_POINTERS: Dict[tuple, ctypes.Array] = {}


def _fused_pointers(w, quant: bool):
    """A host array of the 24 pointers decode_fused.cu reads (`read_layer`):
    the LayerNorm vectors and FFN biases, the eight matrices, their scales
    (null for f32), from weights in layer_weights' order (one layer, or
    stack_decoder_layers' [nl, ...] tensors). Checked once per set of
    tensors (device, dtype, contiguity), then cached by address and dtype:
    the beam loops pass the same weights at every position."""
    key = (quant,) + tuple((t.data_ptr(), t.dtype) for t in w)
    arr = _POINTERS.get(key)
    if arr is not None:
        return arr
    p = _pairs(w, quant)
    vecs = [p[i] for i in (0, 1, 6, 7, 10, 11, 13, 15)]
    mats = [p[i] for i in _MATS]
    wdt = torch.int8 if quant else torch.float32
    for t in vecs + [m[1] for m in mats if m[1] is not None]:
        kernels.check(t, torch.float32, "layer vectors and scales")
    for m, _ in mats:
        kernels.check(m, wdt, "streamed matrices")
    ptrs = ([t.data_ptr() for t in vecs] + [m.data_ptr() for m, _ in mats]
            + [0 if s is None else s.data_ptr() for _, s in mats])
    if len(_POINTERS) >= 256:
        _POINTERS.clear()
    arr = _POINTERS[key] = (ctypes.c_void_p * 24)(*ptrs)
    return arr


def _check_fused(ck, mk):
    if mk.dtype != ck.dtype:
        raise ValueError(f"the fused decode kernels take self caches and memory K/V "
                         f"of one dtype, got {ck.dtype} and {mk.dtype}")


def _layer_cuda(w, quant, x, ck, cv, mk, mv, pos, n_head, anc, group,
                mem_mask, maskk):
    """K5 on the card: one cooperative launch of decode_fused.cu
    `decoder_layer_fused` (the same layer as _layer_plain, f32 or int8
    weights, caches in their dtype)."""
    _check_fused(ck, mk)
    BK, D = x.shape
    FF = w[12].shape[1] if not quant else w[18].shape[1]
    Lpad, Lk = ck.shape[2], mk.shape[1]
    plan = fused_plan(BK, D, FF, n_head, Lpad, Lk, quant, K=group)
    ptrs = _fused_pointers(w, quant)
    y = torch.empty_like(x)
    ws = torch.empty((plan["ws_floats"],), device=x.device, dtype=torch.float32)
    kernels.launch("decoder_layer_fused", ctypes.addressof(ptrs), int(quant),
                   int(ck.dtype == torch.bfloat16), x, y, ck, cv, mk, mv, anc, maskk,
                   mem_mask, ws, _tiles_on(x.device, BK, D, FF, 0), plan["ws_floats"], pos,
                   BK, group, Lpad, Lk, D, FF, n_head, plan["smem"], FUSED_GRID)
    return y


def _run_layers(layer_fn, stacked, x, cache_k, cache_v, mem_k, mem_v, *args):
    """layer_fn over the stacked layers (the (tensors, quant) pair of
    stack_decoder_layers), layer l on its slices of the stacked weights and
    caches."""
    tensors, quant = stacked
    for layer in range(cache_k.shape[0]):
        x = layer_fn(tuple(t[layer] for t in tensors), quant, x, cache_k[layer],
                     cache_v[layer], mem_k[layer], mem_v[layer], *args)
    return x


def _check_cuda_args(cache_k, cache_v, mem_k, mem_v, anc, maskk, mem_mask):
    _check_streams((cache_k, cache_v, "self caches"), (mem_k, mem_v, "memory K/V"))
    for t, nm in ((anc, "anc"), (maskk, "self_mask_k"), (mem_mask, "mem_mask")):
        kernels.check(t, torch.int32, nm)


def decoder_layer_step_plain(params: Dict, x_new, cache_k, cache_v, mem_k,
                             mem_v, pos: int, n_head: int, anc, group: int,
                             mem_mask, self_mask_k):
    """Plain PyTorch version of K5; same arguments and results."""
    w, quant = layer_weights(params)
    return _layer_plain(w, quant, x_new, cache_k, cache_v, mem_k, mem_v, pos,
                        n_head, anc, group, mem_mask, self_mask_k)


def decoder_layer_step_flash(params: Dict, x_new, cache_k, cache_v, mem_k,
                             mem_v, pos: int, n_head: int, anc, group: int,
                             mem_mask, self_mask_k):
    """One decoder layer's decode step (K5): params is one layer's tree
    (decslf_attn / encdec_attn / pos_ffn), f32 or quantized; x_new [BK, D]
    its input at `pos`, cache_k/v [K, B, Lpad, D] the layer's self caches
    (updated in place at `pos`), mem_k/v [B, Lk_pad, D], each pair f32 or
    bf16; anc[pos] must hold each row's own slot. Returns the layer's
    output [BK, D] f32."""
    w, quant = layer_weights(params)
    if not x_new.is_cuda:
        return _layer_plain(w, quant, x_new, cache_k, cache_v, mem_k, mem_v,
                            pos, n_head, anc, group, mem_mask, self_mask_k)
    kernels.refuse_grad("decoder_layer_step_flash", TRAINABLE, x_new, mem_k,
                        mem_v, *w)
    _check_cuda_args(cache_k, cache_v, mem_k, mem_v, anc, self_mask_k, mem_mask)
    y = _layer_cuda(w, quant, x_new.contiguous(), cache_k, cache_v, mem_k, mem_v,
                    pos, n_head, anc, group, mem_mask, self_mask_k)
    _count(decoder_layer_step_flash, _variant(quant, cache_k))
    return y


_init_counts(decoder_layer_step_flash, VARIANTS)


# ---------------------------------------------------------------------------
# K6a-c: the layer step as three launches (JAX self_attn_step,
# cross_attn_step, ffn_step), on a head shard under tensor parallelism
# ---------------------------------------------------------------------------


def _ln_of(p, x):
    return _ln(x, p["layer_norm"]["scale"], p["layer_norm"]["bias"], 1e-6)


def _ln_card(p, x):
    return kernels.layernorm(x, p["layer_norm"]["scale"], p["layer_norm"]["bias"], 1e-6)


def _check_width(params: Dict, key: str, stream, name: str):
    dq = params[key]["w"].shape[1]
    if stream.shape[-1] != dq:
        raise ValueError(f"{name} are {stream.shape[-1]} wide, the projection "
                         f"{key} gives {dq}")


def self_attn_step_plain(params: Dict, x_new, cache_k, cache_v, pos: int,
                         n_head: int, anc, group: int, mask_k,
                         residual: bool = True):
    """Plain PyTorch version of K6a (self_attn_step); same arguments and
    results."""
    q = _ln_of(params, x_new) @ params["w_qs"]["w"]
    att = self_attn_anc_plain(q, x_new @ params["w_ks"]["w"],
                              x_new @ params["w_vs"]["w"], cache_k, cache_v,
                              anc, mask_k, pos, group, n_head)
    y = att @ params["fc"]["w"]
    return y + x_new if residual else y


def self_attn_step(params: Dict, x_new, cache_k, cache_v, pos: int,
                   n_head: int, anc, group: int, mask_k,
                   residual: bool = True):
    """K6a, the self-attention third of a layer step: pre-LN, Q from the
    normed x and K/V from the raw x ([D, Dq] each), the new K/V row into
    the caches [K, B, Lpad, Dq] at `pos` (in place, f32 or bf16), ancestry
    attention over 0..pos, then fc [Dq, D], plus x with `residual`. Under
    tensor parallelism params hold a head shard (Dq = D / n_model),
    n_head is the local head count and residual=False returns the partial
    the shards sum. x_new [BK, D]; anc and mask_k [Lpad, BK] int32.
    Returns y [BK, D] f32 (`launches`, `bf16_launches`)."""
    if not x_new.is_cuda:
        return self_attn_step_plain(params, x_new, cache_k, cache_v, pos,
                                    n_head, anc, group, mask_k, residual)
    kernels.refuse_grad("self_attn_step", TRAINABLE, x_new, *leaves(params))
    _check_streams((cache_k, cache_v, "self caches"))
    _check_width(params, "w_ks", cache_k, "self caches")
    for t, nm in ((anc, "anc"), (mask_k, "mask_k")):
        kernels.check(t, torch.int32, nm)
    x = x_new.contiguous()
    q = kernels.gemm(_ln_card(params, x), params["w_qs"]["w"])
    att = _self_attn_cuda(q, kernels.gemm(x, params["w_ks"]["w"]),
                          kernels.gemm(x, params["w_vs"]["w"]), cache_k,
                          cache_v, anc, mask_k, pos, group, n_head)
    y = kernels.gemm(att, params["fc"]["w"], residual=x if residual else None)
    _count(self_attn_step, _variant(False, cache_k))
    return y


def cross_attn_step_plain(params: Dict, x_new, mem_k, mem_v, n_head: int,
                          group: int, mem_mask, residual: bool = True):
    """Plain PyTorch version of K6b (cross_attn_step); same arguments and
    results."""
    q = _ln_of(params, x_new) @ params["w_qs"]["w"]
    y = cross_attn_plain(q, mem_k, mem_v, mem_mask, group, n_head) @ params["fc"]["w"]
    return y + x_new if residual else y


def cross_attn_step(params: Dict, x_new, mem_k, mem_v, n_head: int,
                    group: int, mem_mask, residual: bool = True):
    """K6b, the cross-attention third: pre-LN, Q [D, Dq], attention over
    the unexpanded memory K/V [B, Lk_pad, Dq] (f32 or bf16; mem_mask
    [Lk_pad, B] int32), fc [Dq, D], plus x with `residual` (a head shard's
    partial without). Returns y [BK, D] f32 (`launches`,
    `bf16_launches`)."""
    if not x_new.is_cuda:
        return cross_attn_step_plain(params, x_new, mem_k, mem_v, n_head,
                                     group, mem_mask, residual)
    kernels.refuse_grad("cross_attn_step", TRAINABLE, x_new, mem_k, mem_v,
                        *leaves(params))
    _check_streams((mem_k, mem_v, "memory K/V"))
    _check_width(params, "w_qs", mem_k, "memory K/V")
    kernels.check(mem_mask, torch.int32, "mem_mask")
    x = x_new.contiguous()
    q = kernels.gemm(_ln_card(params, x), params["w_qs"]["w"])
    y = kernels.gemm(_cross_attn_cuda(q, mem_k, mem_v, mem_mask, group, n_head),
                     params["fc"]["w"], residual=x if residual else None)
    _count(cross_attn_step, _variant(False, mem_k))
    return y


def ffn_step_plain(params: Dict, x_new, partial_tp: bool = False):
    """Plain PyTorch version of K6c (ffn_step); same arguments and results."""
    h = torch.relu(_ln_of(params, x_new) @ params["w_1"]["w"] + params["w_1"]["b"])
    y = h @ params["w_2"]["w"]
    return y if partial_tp else y + params["w_2"]["b"] + x_new


def ffn_step(params: Dict, x_new, partial_tp: bool = False):
    """K6c, the FFN third: LN -> w_1 + b_1 -> ReLU -> w_2, then + b_2 + x.
    partial_tp: w_1 and b_1 hold a hidden shard (FF / n_model columns) and
    w_2 its rows; the partial h @ w_2 is returned, and the caller adds
    x + the shards' sum + b_2. Returns y [BK, D] f32 (`launches`)."""
    if not x_new.is_cuda:
        return ffn_step_plain(params, x_new, partial_tp)
    kernels.refuse_grad("ffn_step", TRAINABLE, x_new, *leaves(params))
    x = x_new.contiguous()
    h = kernels.gemm(_ln_card(params, x), params["w_1"]["w"], bias=params["w_1"]["b"],
                     relu=True)
    y = (kernels.gemm(h, params["w_2"]["w"]) if partial_tp else
         kernels.gemm(h, params["w_2"]["w"], bias=params["w_2"]["b"], residual=x))
    ffn_step.launches += 1
    return y


_init_counts(self_attn_step, ("", "bf16_"))
_init_counts(cross_attn_step, ("", "bf16_"))
ffn_step.launches = 0


def decoder_layer_step_flash_trio(params: Dict, x_new, cache_k, cache_v,
                                  mem_k, mem_v, pos: int, n_head: int, anc,
                                  group: int, mem_mask, self_mask_k):
    """K5's layer step as K6a, K6b and K6c in turn, each with its residual
    (JAX decode_flash.py:869): the single-device A/B check that the three
    launches compute K5. Same arguments and results as
    decoder_layer_step_flash (f32 weights); on CPU tensors the plain
    versions."""
    y = self_attn_step(params["decslf_attn"], x_new, cache_k, cache_v, pos,
                       n_head, anc, group, self_mask_k)
    y = cross_attn_step(params["encdec_attn"], y, mem_k, mem_v, n_head, group,
                        mem_mask)
    return ffn_step(params["pos_ffn"], y)


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along the last dim by repeated arg-max: values descending, the
    lowest index first among ties (jax.lax.top_k's order; torch.topk
    documents none)."""
    x = x.clone()
    vals, ids = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)  # first occurrence
        vals.append(x.gather(-1, i))
        ids.append(i)
        x.scatter_(-1, i, -1e30)
    return torch.cat(vals, -1), torch.cat(ids, -1)


def _head_plain(norm_params, out_params, x, topk, gather_ids=None):
    logp = torch.log_softmax(layer_norm(norm_params, x, 1e-5) @ out_params["w"],
                             dim=-1)
    sc, ids = topk_lowest_index(logp, topk)
    if gather_ids is None:
        return sc, ids.to(torch.int32)
    return sc, ids.to(torch.int32), logp.gather(1, gather_ids.long()[:, None])[:, 0]


def _head_cuda(norm_params, out_params, x, topk, gather_ids=None):
    """K7's launch sequence: layernorm (eps 1e-5), the GEMM, head_topk."""
    logits = kernels.gemm(
        kernels.layernorm(x, norm_params["scale"], norm_params["bias"], 1e-5),
        out_params["w"])
    BK, V = logits.shape
    dev = x.device
    sc = torch.empty((BK, topk), device=dev, dtype=torch.float32)
    ids = torch.empty((BK, topk), device=dev, dtype=torch.int32)
    if gather_ids is None:
        kernels.launch("head_topk", logits, None, sc, ids, None, BK, V, topk)
        return sc, ids
    gid = kernels.check(gather_ids.to(torch.int32).contiguous(), torch.int32,
                        "gather_ids")
    glp = torch.empty((BK,), device=dev, dtype=torch.float32)
    kernels.launch("head_topk", logits, gid, sc, ids, glp, BK, V, topk)
    return sc, ids, glp


def decode_head_plain(norm_params: Dict, out_params: Dict, x, topk: int):
    """Plain PyTorch version of K7 (decode_head); same arguments and results."""
    return _head_plain(norm_params, out_params, x, topk)


def decode_head_gather_plain(norm_params: Dict, out_params: Dict, x, topk: int,
                             gather_ids):
    """Plain PyTorch version of K7's gather variant; same arguments and
    results."""
    return _head_plain(norm_params, out_params, x, topk, gather_ids)


def decode_head(norm_params: Dict, out_params: Dict, x, topk: int):
    """K7: final LayerNorm (eps 1e-5) -> x @ out_params["w"] -> log-softmax
    -> top-K for x [BK, D], the decoder output before its final norm.
    Returns (scores [BK, topk], ids [BK, topk] int32), ties to the lowest
    id."""
    if not x.is_cuda:
        return decode_head_plain(norm_params, out_params, x, topk)
    kernels.refuse_grad("decode_head", TRAINABLE, x, *norm_params.values(),
                        *out_params.values())
    out = _head_cuda(norm_params, out_params, x.contiguous(), topk)
    decode_head.launches += 1
    return out


decode_head.launches = 0


def decode_head_gather(norm_params: Dict, out_params: Dict, x, topk: int,
                       gather_ids):
    """K7 plus glp [BK], the log-softmax at gather_ids [BK] (the reference
    token greedy dev eval scores). Returns (scores, ids, glp)."""
    if not x.is_cuda:
        return decode_head_gather_plain(norm_params, out_params, x, topk,
                                        gather_ids)
    kernels.refuse_grad("decode_head_gather", TRAINABLE, x,
                        *norm_params.values(), *out_params.values())
    out = _head_cuda(norm_params, out_params, x.contiguous(), topk, gather_ids)
    decode_head_gather.launches += 1
    return out


decode_head_gather.launches = 0


def decode_head_partial_plain(norm_params: Dict, out_params: Dict, x,
                              topk: int, gather_ids=None):
    """Plain PyTorch version of K7c (decode_head_partial); same arguments
    and results. A shard narrower than topk gives -1e30 at id 0 past its
    width, as the repeated arg-max of topk_lowest_index and of the TPU
    kernel do."""
    logits = layer_norm(norm_params, x, 1e-5) @ out_params["w"]
    mx = logits.max(dim=-1).values
    se = torch.exp(logits - mx[:, None]).sum(dim=-1)
    sc, ids = topk_lowest_index(logits, topk)
    if gather_ids is None:
        return sc, ids.to(torch.int32), mx, se
    g = gather_ids.long()
    inside = (g >= 0) & (g < logits.shape[1])
    glog = logits.gather(1, g.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    return sc, ids.to(torch.int32), mx, se, torch.where(inside, glog, 0.0)


def decode_head_partial(norm_params: Dict, out_params: Dict, x, topk: int,
                        gather_ids=None):
    """K7c, one vocabulary shard of the decode head (JAX
    decode_flash.py:1666): final LayerNorm (eps 1e-5) -> x @ out_params["w"]
    [D, V/n] -> the RAW top-K logits [BK, topk] and their LOCAL ids int32
    (lowest id first among ties), mx [BK] the row max and se [BK] = sum
    exp(logit - mx); with gather_ids [BK], already offset into the shard,
    also the raw logit there, 0 for an id outside [0, V/n). Returns (sc,
    ids, mx, se[, glog]); ops/decode_flash_tp.py decode_head_tp merges the
    shards (`launches`)."""
    if not x.is_cuda:
        return decode_head_partial_plain(norm_params, out_params, x, topk,
                                         gather_ids)
    kernels.refuse_grad("decode_head_partial", TRAINABLE, x,
                        *norm_params.values(), *out_params.values())
    logits = kernels.gemm(
        kernels.layernorm(x.contiguous(), norm_params["scale"],
                          norm_params["bias"], 1e-5), out_params["w"])
    BK, V = logits.shape
    f32 = dict(device=x.device, dtype=torch.float32)
    sc, mx, se = (torch.empty((BK, topk), **f32), torch.empty((BK,), **f32),
                  torch.empty((BK,), **f32))
    ids = torch.empty((BK, topk), device=x.device, dtype=torch.int32)
    gid = glog = None
    if gather_ids is not None:
        gid = kernels.check(gather_ids.to(torch.int32).contiguous(), torch.int32,
                            "gather_ids")
        glog = torch.empty((BK,), **f32)
    kernels.launch("head_topk_partial", logits, gid, sc, ids, glog, mx, se, BK,
                   V, topk)
    decode_head_partial.launches += 1
    return (sc, ids, mx, se) if gid is None else (sc, ids, mx, se, glog)


decode_head_partial.launches = 0


def decode_chain_step_plain(stacked, norm_params, out_params, x_new, cache_k,
                            cache_v, mem_k, mem_v, pos: int, n_head: int, anc,
                            group: int, mem_mask, self_mask_k, topk: int,
                            gather_ids: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3; same arguments and results."""
    x = _run_layers(_layer_plain, stacked, x_new, cache_k, cache_v, mem_k,
                    mem_v, pos, n_head, anc, group, mem_mask, self_mask_k)
    return _head_plain(norm_params, out_params, x, topk, gather_ids)


def decode_chain_step_flash(stacked, norm_params, out_params, x_new, cache_k,
                            cache_v, mem_k, mem_v, pos: int, n_head: int, anc,
                            group: int, mem_mask, self_mask_k, topk: int,
                            gather_ids: Optional[torch.Tensor] = None):
    """One decode position through all layers and the head.

    stacked: the (tensors, quant) pair of stack_decoder_layers. x_new
    [BK, D] (token embedding + time signal at `pos`); caches as in the
    module docstring, f32 or bf16, updated in place at `pos`; anc[pos]
    must hold each row's own slot. Returns (scores [BK, topk] log-probs,
    ids [BK, topk] int32), ties to the lowest id, and with gather_ids [BK]
    also glp [BK], the log-prob at those ids. Launches are counted per
    variant (module docstring), with gather_ids under `gather_`."""
    if not x_new.is_cuda:
        return decode_chain_step_plain(stacked, norm_params, out_params, x_new,
                                       cache_k, cache_v, mem_k, mem_v, pos,
                                       n_head, anc, group, mem_mask,
                                       self_mask_k, topk, gather_ids)
    kernels.refuse_grad("decode_chain_step_flash", TRAINABLE, x_new, mem_k,
                        mem_v, *stacked[0], *norm_params.values(),
                        *out_params.values())
    _check_cuda_args(cache_k, cache_v, mem_k, mem_v, anc, self_mask_k, mem_mask)
    x = _run_layers(_layer_cuda, stacked, x_new.contiguous(), cache_k, cache_v,
                    mem_k, mem_v, pos, n_head, anc, group, mem_mask,
                    self_mask_k)
    out = _head_cuda(norm_params, out_params, x, topk, gather_ids)
    _count(decode_chain_step_flash, ("" if gather_ids is None else "gather_")
           + _variant(stacked[1], cache_k))
    return out


_init_counts(decode_chain_step_flash, VARIANTS, ("", "gather_"))


def beam_candidates(sc, scores, eos, lenm, penalty_factor: float):
    """The k^2 candidate scores of a beam step (ref: Seq2seq.py:358-371):
    sc [BK, K] head log-probs; a finished row contributes column 0 at +0
    and -1e9 elsewhere; ranked by score / lenm^pf. Returns (st [B, K*K]
    with flat index j*K + c for source row b*K + j, lp = lenm^pf [BK])."""
    BK, K = sc.shape
    eosb = (eos != 0)[:, None]
    lp = lenm if penalty_factor == 1.0 else lenm ** penalty_factor
    col = torch.arange(K, device=sc.device)[None, :]
    sm = torch.where(eosb, torch.zeros_like(sc), sc)
    sm = torch.where(eosb & (col >= 1), torch.full_like(sc, NEG), sm)
    return ((scores[:, None] + sm) / lp[:, None]).reshape(BK // K, K * K), lp


def beam_select_plain(sc, ids, scores, eos, lenm, preds, anc, maskk, i: int,
                      group: int, penalty_factor: float):
    """The k^2 -> k update of beam position i from the head's sc / ids
    [BK, K] (ref: beam.py body(), Seq2seq.py:358-391): top-K of the
    candidates with the lowest flat index first; the kept score multiplied
    back by the OLD slot's penalty; eos / lenm stay slot-indexed; preds
    [BK, Lpad], anc and maskk [Lpad, BK] back-copied from the source rows,
    token i written. Returns (preds, anc, maskk, last_tok, scores, eos,
    lenm, all_eos_flag [1]) as new tensors, as K4 does."""
    BK = preds.shape[0]
    K = group
    B = BK // K
    st, lp = beam_candidates(sc, scores, eos, lenm, penalty_factor)
    sel, flat = topk_lowest_index(st, K)
    src = (torch.arange(B, device=preds.device)[:, None] * K + flat // K).view(-1)
    tok_sel = ids[src, (flat % K).view(-1)]
    preds_n = preds[src]  # advanced indexing copies
    preds_n[:, i] = tok_sel
    anc_n = anc[:, src].contiguous()
    maskk_n = maskk[:, src]
    maskk_n[i] = (tok_sel != PAD).to(maskk.dtype)
    eos_n = (eos != 0) | (tok_sel == EOS)
    lenm_n = lenm + torch.where(eos_n, 0.0, 1.0)
    flag = eos_n.all().to(torch.int32).reshape(1)
    return (preds_n, anc_n, maskk_n, tok_sel.to(torch.int32),
            sel.reshape(-1) * lp, eos_n.to(torch.int32), lenm_n, flag)


def beam_select(sc, ids, scores, eos, lenm, preds, anc, maskk, i: int,
                group: int, penalty_factor: float):
    """The k^2 -> k update of beam position i, with beam_select_plain's
    arguments and results. On CUDA tensors it launches csrc/decode.cu's
    select kernel, whose body (csrc/head_select.cuh) is also the fused
    megastep's last phase, so the general beam loop and the megastep share
    one select on the card."""
    if not preds.is_cuda:
        return beam_select_plain(sc, ids, scores, eos, lenm, preds, anc, maskk,
                                 i, group, penalty_factor)
    kernels.refuse_grad("beam_select", "beam_select_plain", sc, scores, lenm)
    f32, i32 = torch.float32, torch.int32
    for t, dt, nm in ((sc, f32, "sc"), (ids, i32, "ids"), (scores, f32, "scores"),
                      (eos, i32, "eos"), (lenm, f32, "lenm"), (preds, i32, "preds"),
                      (anc, i32, "anc"), (maskk, i32, "maskk")):
        kernels.check(t, dt, nm)
    BK, L = preds.shape
    outs = (torch.empty_like(preds), torch.empty_like(anc), torch.empty_like(maskk),
            torch.empty((BK,), device=preds.device, dtype=i32), torch.empty_like(scores),
            torch.empty_like(eos), torch.empty_like(lenm),
            torch.ones((1,), device=preds.device, dtype=i32))  # the all-EOS flag, and-ed
    kernels.launch("beam_select", sc, ids, scores, eos, lenm, preds, anc, maskk, *outs, i,
                   BK // group, group, L, float(penalty_factor))
    beam_select.launches += 1
    return outs


beam_select.launches = 0


def decode_beam_step_plain(stacked, norm_params, out_params, emb_table,
                           time_sig, i: int, last_tok, preds, anc, maskk,
                           mem_mask, scores, eos, lenm, cache_k, cache_v,
                           mem_k, mem_v, n_head: int, group: int,
                           penalty_factor: float):
    """Plain PyTorch version of K4; same arguments and results."""
    K = group
    pos = i - 1
    row = torch.arange(preds.shape[0], device=preds.device)
    anc[pos] = (row % K).to(anc.dtype)
    tok = last_tok.long()
    x = emb_table[tok] * (tok != PAD)[:, None].to(emb_table.dtype) + time_sig[pos]
    x = _run_layers(_layer_plain, stacked, x, cache_k, cache_v, mem_k, mem_v,
                    pos, n_head, anc, K, mem_mask, maskk)
    sc, ids = _head_plain(norm_params, out_params, x, K)
    return beam_select_plain(sc, ids, scores, eos, lenm, preds, anc, maskk, i,
                             K, penalty_factor)


def decode_beam_step_flash(stacked, norm_params, out_params, emb_table,
                           time_sig, i: int, last_tok, preds, anc, maskk,
                           mem_mask, scores, eos, lenm, cache_k, cache_v,
                           mem_k, mem_v, n_head: int, group: int,
                           penalty_factor: float):
    """One beam position: embed last_tok [BK] + time_sig[i-1] -> layers ->
    head -> k^2 -> k select. stacked is the (tensors, quant) pair of
    stack_decoder_layers; caches f32 or bf16 (launches counted per variant,
    module docstring). preds [BK, Lpad] / anc / maskk [Lpad, BK] int32,
    scores / lenm [BK] f32, eos [BK] int32. Returns (preds, anc, maskk,
    last_tok, scores, eos, lenm, all_eos_flag [1]) as new tensors; the
    caches and anc[i-1] are updated in place."""
    if not preds.is_cuda:
        return decode_beam_step_plain(stacked, norm_params, out_params,
                                      emb_table, time_sig, i, last_tok, preds,
                                      anc, maskk, mem_mask, scores, eos, lenm,
                                      cache_k, cache_v, mem_k, mem_v, n_head,
                                      group, penalty_factor)
    kernels.refuse_grad("decode_beam_step_flash", TRAINABLE, emb_table,
                        time_sig, scores, mem_k, mem_v, *stacked[0],
                        *norm_params.values(), *out_params.values())
    _check_cuda_args(cache_k, cache_v, mem_k, mem_v, anc, maskk, mem_mask)
    for t, dt, nm in ((last_tok, torch.int32, "last_tok"),
                      (preds, torch.int32, "preds"),
                      (scores, torch.float32, "scores"),
                      (eos, torch.int32, "eos"), (lenm, torch.float32, "lenm"),
                      (emb_table, torch.float32, "emb_table"),
                      (time_sig, torch.float32, "time_sig")):
        kernels.check(t, dt, nm)
    _check_fused(cache_k, mem_k)
    for t, nm in ((norm_params["scale"], "norm scale"), (norm_params["bias"], "norm bias"),
                  (out_params["w"], "out_params w")):
        kernels.check(t, torch.float32, nm)
    tensors, quant = stacked
    nl, K, B, Lpad, D = cache_k.shape
    BK, Lbuf = preds.shape
    V, Lk = out_params["w"].shape[1], mem_k.shape[2]
    FF = tensors[18 if quant else 12].shape[-1]
    plan = fused_plan(BK, D, FF, n_head, Lpad, Lk, quant, beam=True, nl=nl, V=V, K=group)
    ptrs = _fused_pointers(tensors, quant)
    dev = preds.device
    outs = (torch.empty_like(preds), torch.empty_like(anc), torch.empty_like(maskk),
            torch.empty((BK,), device=dev, dtype=torch.int32), torch.empty_like(scores),
            torch.empty_like(eos), torch.empty_like(lenm),
            torch.empty((1,), device=dev, dtype=torch.int32))
    ws = torch.empty((plan["ws_floats"],), device=dev, dtype=torch.float32)
    kernels.launch("decode_beam_fused", ctypes.addressof(ptrs), int(quant),
                   int(cache_k.dtype == torch.bfloat16), norm_params["scale"],
                   norm_params["bias"], out_params["w"], emb_table, time_sig, last_tok, preds,
                   anc, maskk, mem_mask, scores, eos, lenm, cache_k, cache_v, mem_k, mem_v,
                   *outs, ws, _tiles_on(dev, BK, D, FF, V), plan["ws_floats"], i, B, group,
                   Lpad, Lbuf, Lk, D, FF, n_head, nl, V, plan["smem"], FUSED_GRID,
                   float(penalty_factor))
    _count(decode_beam_step_flash, _variant(quant, cache_k))
    return outs


_init_counts(decode_beam_step_flash, VARIANTS)
