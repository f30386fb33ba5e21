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
through every layer and the head. K4 is the whole beam while-body: embed +
time signal, the layers, the head, and the k^2 -> k select with its
back-copies; `beam_select` is that select alone, for the general beam
loop. On the card K3, K4, K5, K6a-c, K7 and K7c are one cooperative
launch each (`csrc/decode_fused.cu`, and `csrc/decode_chain.cu` for K3, K7
and K7c, on the phases of `csrc/decode_fused.cuh`; from the shapes alone,
`fused_tiles` gives the tile table they walk and `fused_plan` their
phases, barriers, shared memory and workspace); the select alone is
`csrc/decode.cu`'s kernel; the tensor-parallel layer step and head are in
`ops/decode_flash_tp.py`.

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
  dtype selects its kernel's variant), rounded where the JAX cores round
  (`self_attn_anc_plain`, `cross_attn_plain`, `csrc/attend.cuh`).
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


def _check_streams(*pairs):
    """Each (a, b, name): two cache tensors of one dtype in CACHE_DTYPES."""
    for a, b, nm in pairs:
        if a.dtype not in CACHE_DTYPES:
            raise ValueError(f"{nm} must be float32 or bfloat16, got {a.dtype}")
        kernels.check(a, a.dtype, nm)
        kernels.check(b, a.dtype, nm)


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
# K5, K4 and K3 on the card: csrc/decode_fused.cu and csrc/decode_chain.cu,
# one cooperative launch each
# ---------------------------------------------------------------------------

FUSED_KC = 64  # contraction depth of a product tile (decode_fused.cuh KC)
FUSED_BM, FUSED_BN = 16, 128  # rows and columns of a product tile
FUSED_THREADS = 256
# blocks of a fused K5, K4 or K3 launch; 0 launches every block the card keeps
# resident; the card tests set it to hold the outputs independent of the grid
FUSED_GRID = 0
# blocks of a fused shard step's or head's launch (K6a-c, K7c, K7); None
# launches the plan's `blocks`; any count is cut to the blocks the card keeps
# resident
STEP_GRID: Optional[int] = None
# K7's top-K takes a row in column slices of HEAD_SLICE ids (256 threads x 8
# registers); a slice's record for the merge is HEAD_CAND floats: 16
# (head_select.cuh MAX_BEAM) raw logits and ids, its max and sum-exp
# (decode_chain.cu SLICE, CAND)
HEAD_SLICE = 2048
HEAD_CAND = 2 * 16 + 2
# the product kinds of the tile table, in decode_fused.cuh's order (P_QKV ..)
FUSED_PRODUCTS = ("qkv", "fc", "cq", "co", "w1", "w2", "head")


def gemm_tiles(M: int, N: int, Kd: int):
    """The tiles of one product [M, Kd] @ [Kd, N] of the fused kernels
    (column tile fastest, then row tile, then split): (split, first row,
    first column); split s sums k in [s*KC, (s+1)*KC)."""
    ct, rt, s = -(-N // FUSED_BN), -(-M // FUSED_BM), -(-Kd // FUSED_KC)
    return [(t // (ct * rt), (t // ct) % rt * FUSED_BM, t % ct * FUSED_BN)
            for t in range(s * rt * ct)]


# the product kinds of the shard steps: K6a (self), K6b (cross), K6c (ffn),
# K7c (head); and of the whole vocabulary's head, K7 (full_head)
STEP_PRODUCTS = {"self": ("qkv", "fc"), "cross": ("cq", "co"), "ffn": ("w1", "w2"),
                 "head": ("head",), "full_head": ("head",)}


def _products(BK: int, D: int, FF: int, V: int = 0, Dq: Optional[int] = None,
              step: Optional[str] = None) -> Dict:
    """{kind: [(M, N, Kd) per job]}, the jobs in decode_fused.cuh
    `layer_jobs` order (q, k, v for qkv) at attention width Dq (D when
    None) and hidden width FF; the head only with V; a shard step's kinds
    only with step ("self", "cross", "ffn", "head" or "full_head")."""
    Dq = D if Dq is None else Dq
    out = {"qkv": [(BK, Dq, D)] * 3, "fc": [(BK, D, Dq)], "cq": [(BK, Dq, D)],
           "co": [(BK, D, Dq)], "w1": [(BK, FF, D)], "w2": [(BK, D, FF)]}
    if V:
        out["head"] = [(BK, V, D)]
    return {k: out[k] for k in STEP_PRODUCTS[step]} if step else out


def fused_tiles(BK: int, D: int, FF: int, V: int = 0, Dq: Optional[int] = None,
                step: Optional[str] = None) -> torch.Tensor:
    """The tile table the fused kernels walk (`tiles`, decode_fused.cuh
    `phase`): int32, 8 offsets (the first tile of each kind of
    FUSED_PRODUCTS, then the end), then one row (job, split, first row,
    first column) per tile, a kind's jobs one after another; `_products`'
    shapes."""
    prods = _products(BK, D, FF, V, Dq, step)
    rows, off = [], []
    for kind in FUSED_PRODUCTS:
        off.append(len(rows))
        for j, (M, N, Kd) in enumerate(prods.get(kind, [])):
            rows += [(j, s, r0, c0) for s, r0, c0 in gemm_tiles(M, N, Kd)]
    off.append(len(rows))
    return torch.tensor(off + [v for row in rows for v in row], dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _tiles_on(device, BK: int, D: int, FF: int, V: int, Dq: Optional[int] = None,
              step: Optional[str] = None) -> torch.Tensor:
    return fused_tiles(BK, D, FF, V, Dq, step).to(device)


def _ws_floats(BK: int, K: int, D: int, Dq: int, FF: int, V: int) -> int:
    """decode_fused.cuh `ws_need`: five [BK, D] activations, PA (q/k/v, w1
    or the head's partials), PB (fc, cq, co or w2's), the logits and the
    head's top-K."""
    kc = FUSED_KC
    sd, sq, sf = -(-D // kc), -(-Dq // kc), -(-FF // kc)
    pa = max(3 * sd * BK * Dq, sd * BK * FF, sd * BK * V)
    pb = max(max(sq, sf) * D, sd * Dq) * BK
    return 5 * BK * D + pa + pb + BK * V + 2 * BK * K


def _prod_smem(wbytes: int) -> int:
    """Two product stages' shared bytes (decode_fused.cuh `prod_smem`)."""
    return 2 * (FUSED_KC * FUSED_BN * wbytes + FUSED_KC * FUSED_BM * 4)


@functools.lru_cache(maxsize=128)
def fused_plan(BK: int, D: int, FF: int, n_head: int, Lpad: int, Lk: int,
               quant: bool = False, beam: bool = False, nl: int = 1, V: int = 0,
               K: int = 1, Dq: Optional[int] = None, step: Optional[str] = None,
               smem_max: Optional[int] = None, chain: bool = False) -> Dict:
    """The launch of fused K5 (one layer) or, with beam, fused K4 (nl
    layers, the head over V ids and the select of B = BK / K groups), or,
    with chain, fused K3 (nl layers and the head over V ids, in groups of
    K rows; the top-K goes straight to its outputs, so topk is not a shape
    of the plan), from the shapes alone: `products` {kind: [(M, N, Kd)]}
    per product job, `phases` [(kind, work items)] in order (a product
    phase's items are its tiles, an attention's (row, head) pairs, a row or
    top-K phase's rows, the select's groups), `barriers` (grid barriers a
    launch), `smem` (dynamic shared bytes a block) and `ws_floats` (f32
    workspace); the kernels walk `fused_tiles` of the same shapes. With
    step, a shard step's launch instead (`_step_plan`; Lpad the self
    cache's rows for K6a, Lk the memory's for K6b, V the vocabulary shard's
    ids for K7c, or the vocabulary's for K7 with step="full_head"; smem_max
    the dynamic shared bytes a block of K6a or K6b may opt in to,
    `step_smem_max` on the card). Cached: the wrappers ask it at every
    launch; treat the result as read-only."""
    if step:
        return _step_plan(step, BK, D, FF, n_head, Lk if step == "cross" else Lpad, K,
                          D if Dq is None else Dq, smem_max, V)
    Dq = D if Dq is None else Dq
    head = beam or chain
    products = _products(BK, D, FF, V if head else 0, Dq)
    tiles = {k: sum(len(gemm_tiles(*job)) for job in jobs) for k, jobs in products.items()}
    att = BK * n_head
    body = [("qkv", tiles["qkv"]), ("self", att), ("fc", tiles["fc"]), ("row", BK),
            ("cq", tiles["cq"]), ("cross", att), ("co", tiles["co"]), ("row", BK),
            ("w1", tiles["w1"]), ("w2", tiles["w2"]), ("row", BK)]
    if beam:
        phases = [("embed", BK)] + body * nl + [("head", tiles["head"]), ("topk", BK),
                                                 ("select", BK // K)]
    elif chain:
        phases = [("row", BK)] + body * nl + [("head", tiles["head"]), ("topk", BK)]
    else:
        phases = [("row", BK)] + body
    wbytes = 4 if head or not quant else 1
    d = Dq // n_head
    smem = max(_prod_smem(wbytes), FUSED_THREADS // 32 * (d + 3 * max(Lpad, Lk)) * 4)
    return dict(products=products, phases=phases, barriers=len(phases) - 1, smem=smem,
                ws_floats=_ws_floats(BK, K, D, Dq, FF, V if head else 0))


def _step_plan(step: str, BK: int, D: int, FF: int, n_head: int, L: int, K: int,
               Dq: int, smem_max: Optional[int], V: int) -> Dict:
    """fused_plan of the shard steps, f32 weights. K6a ("self": the
    attention width Dq, n_head local heads, L = Lpad cache rows, groups of K
    rows; FF unused): row, qkv, self, fc, row. K6b ("cross": the same over
    L = Lk memory rows): row, cq, cross, co, row. K6c ("ffn": the hidden
    width FF; Dq, n_head, L unused): row, w1, w2, row. K7c ("head": the
    vocabulary shard's V ids; FF, Dq, n_head, L, K unused): row, head,
    topk. K7 ("full_head": the vocabulary's V ids, the same unused): row,
    head, then `slices` = ceil(V / HEAD_SLICE) items a row of the top-K by
    column slices ("slice"), and above one slice a row the merge of each
    row's slices ("merge"). Also `att_warps`, the warps a block runs
    attention items on (as many of 8 as smem_max bytes stage), and
    `blocks`, the blocks the launch asks for: as many as its largest phase
    has items (an attention phase's in att_warps items a block)."""
    head = step in ("head", "full_head")
    if step == "ffn" or head:
        Dq, n_head, L, K = 0, 1, 0, 1
    if step != "ffn":
        FF = 0
    if not head:
        V = 0
    products = _products(BK, D, FF, V, Dq, step)
    tiles = {k: sum(len(gemm_tiles(*job)) for job in jobs) for k, jobs in products.items()}
    smem, aw, extra = _prod_smem(4), 0, {}
    if step == "head":
        phases = [("row", BK), ("head", tiles["head"]), ("topk", BK)]
    elif step == "full_head":
        n_slices = -(-V // HEAD_SLICE)
        phases = [("row", BK), ("head", tiles["head"]), ("slice", BK * n_slices)]
        phases += [("merge", BK)] if n_slices > 1 else []
        extra = dict(slices=n_slices)
    else:
        first, second = STEP_PRODUCTS[step]
        phases = [("row", BK), (first, tiles[first])]
    if step in ("self", "cross"):
        if smem_max is None:
            raise ValueError(f"the {step} step's plan needs smem_max, the card's limit "
                             f"(step_smem_max)")
        per = (Dq // n_head + 3 * L) * 4  # an attention item's staging
        smem = max(smem, min(FUSED_THREADS // 32, smem_max // per) * per)
        aw = min(FUSED_THREADS // 32, smem // per)
        if aw < 1:
            rows = "cache rows" if step == "self" else "memory rows"
            raise ValueError(f"{step}_attn_step: {L} {rows} at head width {Dq // n_head} "
                             f"stage past {smem_max} bytes a block")
        phases.append((step, BK * n_head))
    if not head:
        phases += [(second, tiles[second]), ("row", BK)]
    blocks = max(-(-n // aw) if kind in ("self", "cross") else n for kind, n in phases)
    return dict(products=products, phases=phases, barriers=len(phases) - 1, smem=smem,
                ws_floats=_ws_floats(BK, K, D, Dq, FF, V), att_warps=aw, blocks=blocks,
                **extra)


# decode_fused.cu `decode_fused_grid` kinds; decode_chain.cu
# `decode_chain_grid` answers for K3 (kind 0), K7c (1) and K7 (2)
_GRID_KIND = {None: 0, "self": 2, "ffn": 3, "cross": 4}
_CHAIN_GRID_KIND = {"head": 1, "full_head": 2}


def fused_grid(quant: bool, bf16: bool, beam: bool, smem: int,
               step: Optional[str] = None, chain: bool = False) -> Dict[str, int]:
    """The card's answer for a fused launch (K5, K4 with beam, K3 with
    chain, or the shard step `step`, K7c's "head" and K7's "full_head"
    among them) at smem bytes: blocks an SM keeps resident and the SM
    count (their product is the most blocks a launch may have), and the
    dynamic shared bytes a block of that kernel may opt in to."""
    out = (ctypes.c_int * 3)()
    if chain or step in _CHAIN_GRID_KIND:
        kernels.launch("decode_chain_grid", int(quant), int(bf16),
                       _CHAIN_GRID_KIND.get(step, 0), smem, ctypes.addressof(out))
    else:
        kernels.launch("decode_fused_grid", int(quant), int(bf16),
                       1 if beam and not step else _GRID_KIND[step], smem,
                       ctypes.addressof(out))
    return dict(blocks_per_sm=out[0], sms=out[1], blocks=out[0] * out[1], smem_max=out[2])


@functools.lru_cache(maxsize=8)
def step_smem_max(step: str, bf16: bool) -> int:
    """The dynamic shared bytes a block of the fused shard step `step`
    ("self" or "cross", bf16 caches or memory or not) may opt in to on the
    card: its opt-in maximum less its static shared memory, as the kernel's
    launch allows it (common.cuh `smem_allow_max`)."""
    return fused_grid(False, bf16, False, 0, step)["smem_max"]


def _step_grid(plan: Dict) -> int:
    return plan["blocks"] if STEP_GRID is None else STEP_GRID


_POINTERS: Dict[tuple, ctypes.Array] = {}


def _fused_pointers(w, quant: bool):
    """A host array of the 24 pointers decode_fused.cuh reads (`read_layer`):
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


def _run_layers(stacked, x, cache_k, cache_v, mem_k, mem_v, *args):
    """_layer_plain over the stacked layers (the (tensors, quant) pair of
    stack_decoder_layers), layer l on its slices of the stacked weights and
    caches: the plain versions of K3 and K4."""
    tensors, quant = stacked
    for layer in range(cache_k.shape[0]):
        x = _layer_plain(tuple(t[layer] for t in tensors), quant, x, cache_k[layer],
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


def _step_weights(params: Dict, shapes, ln: Dict, D: int):
    """The matrices a fused shard step reads, each checked f32, contiguous,
    on the card and of its shape ((key, shape) pairs), and the LayerNorm's
    [D] vectors: the kernel reads them by pointer at those shapes."""
    for nm in ("scale", "bias"):
        if kernels.check(ln[nm], torch.float32, f"layer_norm {nm}").numel() != D:
            raise ValueError(f"layer_norm {nm} has {ln[nm].numel()} entries, not {D}")
    mats = []
    for key, shape in shapes:
        w = kernels.check(params[key]["w"], torch.float32, f"{key} w")
        if tuple(w.shape) != shape:
            raise ValueError(f"{key} w is {tuple(w.shape)}, the step takes {shape}")
        mats.append(w)
    return mats


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
    if torch.is_grad_enabled():  # leaves() costs ~8 us a call; the TP beam runs without grad
        kernels.refuse_grad("self_attn_step", TRAINABLE, x_new, *leaves(params))
    _check_streams((cache_k, cache_v, "self caches"))
    _check_width(params, "w_ks", cache_k, "self caches")
    for t, nm in ((anc, "anc"), (mask_k, "mask_k")):
        kernels.check(t, torch.int32, nm)
    x = kernels.check(x_new.contiguous(), torch.float32, "x_new")
    BK, D = x.shape
    if (cache_k.dim() != 4 or cache_k.shape[:2] != (group, BK // group)
            or cache_v.shape != cache_k.shape
            or any(t.dim() != 2 or t.shape[0] <= pos or t.shape[1] != BK for t in (anc, mask_k))):
        raise ValueError(f"self_attn_step: caches {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}, anc {tuple(anc.shape)} and mask_k "
                         f"{tuple(mask_k.shape)} do not fit {BK} rows in groups of {group} "
                         f"at position {pos}")
    Dq, Lpad = cache_k.shape[-1], cache_k.shape[2]
    ln = params["layer_norm"]
    mats = _step_weights(params, (("w_qs", (D, Dq)), ("w_ks", (D, Dq)), ("w_vs", (D, Dq)),
                                  ("fc", (Dq, D))), ln, D)
    bf16 = cache_k.dtype == torch.bfloat16
    plan = fused_plan(BK, D, 0, n_head, Lpad, 0, K=group, Dq=Dq, step="self",
                      smem_max=step_smem_max("self", bf16))
    y = torch.empty_like(x)
    ws = torch.empty((plan["ws_floats"],), device=x.device, dtype=torch.float32)
    kernels.launch("self_attn_step_fused", ln["scale"], ln["bias"], *mats, x, y, cache_k,
                   cache_v, anc, mask_k, ws, _tiles_on(x.device, BK, D, 0, 0, Dq, "self"),
                   int(bf16), int(residual), plan["ws_floats"], pos, BK, group, Lpad, D, Dq,
                   n_head, plan["smem"], _step_grid(plan))
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
    if torch.is_grad_enabled():
        kernels.refuse_grad("cross_attn_step", TRAINABLE, x_new, mem_k, mem_v,
                            *leaves(params))
    _check_streams((mem_k, mem_v, "memory K/V"))
    _check_width(params, "w_qs", mem_k, "memory K/V")
    kernels.check(mem_mask, torch.int32, "mem_mask")
    x = kernels.check(x_new.contiguous(), torch.float32, "x_new")
    BK, D = x.shape
    B = BK // group
    if (mem_k.dim() != 3 or mem_k.shape[0] != B or mem_v.shape != mem_k.shape
            or tuple(mem_mask.shape) != (mem_k.shape[1], B) or BK % group):
        raise ValueError(f"cross_attn_step: memory K/V {tuple(mem_k.shape)}, "
                         f"{tuple(mem_v.shape)} and mem_mask {tuple(mem_mask.shape)} do not "
                         f"fit {BK} rows in groups of {group}")
    Dq, Lk = mem_k.shape[-1], mem_k.shape[1]
    ln = params["layer_norm"]
    mats = _step_weights(params, (("w_qs", (D, Dq)), ("fc", (Dq, D))), ln, D)
    bf16 = mem_k.dtype == torch.bfloat16
    plan = fused_plan(BK, D, 0, n_head, 0, Lk, K=group, Dq=Dq, step="cross",
                      smem_max=step_smem_max("cross", bf16))
    y = torch.empty_like(x)
    ws = torch.empty((plan["ws_floats"],), device=x.device, dtype=torch.float32)
    kernels.launch("cross_attn_step_fused", ln["scale"], ln["bias"], *mats, x, y, mem_k, mem_v,
                   mem_mask, ws, _tiles_on(x.device, BK, D, 0, 0, Dq, "cross"),
                   int(bf16), int(residual), plan["ws_floats"], BK, group, Lk, D, Dq, n_head,
                   plan["smem"], _step_grid(plan))
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
    if torch.is_grad_enabled():
        kernels.refuse_grad("ffn_step", TRAINABLE, x_new, *leaves(params))
    x = kernels.check(x_new.contiguous(), torch.float32, "x_new")
    BK, D = x.shape
    FF = params["w_1"]["w"].shape[-1]
    ln, b1, b2 = params["layer_norm"], params["w_1"]["b"], params["w_2"]["b"]
    w1, w2 = _step_weights(params, (("w_1", (D, FF)), ("w_2", (FF, D))), ln, D)
    for t, n, nm in ((b1, FF, "w_1 b"), (b2, D, "w_2 b")):
        if kernels.check(t, torch.float32, nm).numel() != n:
            raise ValueError(f"ffn_step: {nm} has {t.numel()} entries, not {n}")
    plan = fused_plan(BK, D, FF, 1, 0, 0, step="ffn")
    y = torch.empty_like(x)
    ws = torch.empty((plan["ws_floats"],), device=x.device, dtype=torch.float32)
    kernels.launch("ffn_step_fused", ln["scale"], ln["bias"], w1, b1, w2, b2, x, y, ws,
                   _tiles_on(x.device, BK, D, FF, 0, None, "ffn"), int(partial_tp),
                   plan["ws_floats"], BK, D, FF, plan["smem"], _step_grid(plan))
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


def _head_args(name, norm_params, out_params, x, topk, gather_ids):
    """K7's and K7c's checks and outputs: (x, w, D, V, sc [BK, topk], ids
    [BK, topk] int32, gid [BK] int32 or None)."""
    x = kernels.check(x.contiguous(), torch.float32, "x")
    BK, D = x.shape
    w = kernels.check(out_params["w"], torch.float32, "out_params w")
    V = w.shape[1]
    if w.shape[0] != D:
        raise ValueError(f"{name}: out_params w is {tuple(w.shape)}, x is {tuple(x.shape)}")
    for nm in ("scale", "bias"):
        if kernels.check(norm_params[nm], torch.float32, f"norm {nm}").numel() != D:
            raise ValueError(f"norm {nm} has {norm_params[nm].numel()} entries, not {D}")
    sc = torch.empty((BK, topk), device=x.device, dtype=torch.float32)
    ids = torch.empty((BK, topk), device=x.device, dtype=torch.int32)
    gid = None if gather_ids is None else kernels.check(
        gather_ids.to(torch.int32).contiguous(), torch.int32, "gather_ids")
    return x, w, D, V, sc, ids, gid


def _head_cuda(norm_params, out_params, x, topk, gather_ids=None):
    """K7 on the card: one cooperative launch of decode_chain.cu
    `head_fused` (LayerNorm, the head's product, the top-K by column
    slices) of as many blocks as its largest phase has items (STEP_GRID
    overrides it)."""
    x, w, D, V, sc, ids, gid = _head_args("decode_head", norm_params, out_params, x, topk,
                                          gather_ids)
    BK = x.shape[0]
    plan = fused_plan(BK, D, 0, 1, 0, 0, V=V, step="full_head")
    glp = None if gid is None else torch.empty((BK,), device=x.device, dtype=torch.float32)
    ws = torch.empty((plan["ws_floats"],), device=x.device, dtype=torch.float32)
    kernels.launch("head_fused", norm_params["scale"], norm_params["bias"], w, x, gid, sc,
                   ids, glp, ws, _tiles_on(x.device, BK, D, 0, V, None, "full_head"),
                   plan["ws_floats"], BK, D, V, topk, plan["smem"], _step_grid(plan))
    return (sc, ids) if gid is None else (sc, ids, glp)


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
    id. On the card one cooperative launch (`head_fused`, `launches`)."""
    if not x.is_cuda:
        return decode_head_plain(norm_params, out_params, x, topk)
    kernels.refuse_grad("decode_head", TRAINABLE, x, *norm_params.values(),
                        *out_params.values())
    out = _head_cuda(norm_params, out_params, x, topk)
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
    out = _head_cuda(norm_params, out_params, x, topk, gather_ids)
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
    shards. On the card one cooperative launch (`head_partial_fused`) of as
    many blocks as its largest phase has items (STEP_GRID overrides it;
    `launches`)."""
    if not x.is_cuda:
        return decode_head_partial_plain(norm_params, out_params, x, topk,
                                         gather_ids)
    kernels.refuse_grad("decode_head_partial", TRAINABLE, x,
                        *norm_params.values(), *out_params.values())
    x, w, D, V, sc, ids, gid = _head_args("decode_head_partial", norm_params, out_params, x,
                                          topk, gather_ids)
    BK = x.shape[0]
    plan = fused_plan(BK, D, 0, 1, 0, 0, V=V, step="head")
    f32 = dict(device=x.device, dtype=torch.float32)
    mx, se = torch.empty((BK,), **f32), torch.empty((BK,), **f32)
    glog = None if gid is None else torch.empty((BK,), **f32)
    ws = torch.empty((plan["ws_floats"],), **f32)
    kernels.launch("head_partial_fused", norm_params["scale"], norm_params["bias"], w, x, gid,
                   sc, ids, mx, se, glog, ws, _tiles_on(x.device, BK, D, 0, V, None, "head"),
                   plan["ws_floats"], BK, D, V, topk, plan["smem"], _step_grid(plan))
    decode_head_partial.launches += 1
    return (sc, ids, mx, se) if gid is None else (sc, ids, mx, se, glog)


decode_head_partial.launches = 0


def decode_chain_step_plain(stacked, norm_params, out_params, x_new, cache_k,
                            cache_v, mem_k, mem_v, pos: int, n_head: int, anc,
                            group: int, mem_mask, self_mask_k, topk: int,
                            gather_ids: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3; same arguments and results."""
    x = _run_layers(stacked, x_new, cache_k, cache_v, mem_k,
                    mem_v, pos, n_head, anc, group, mem_mask, self_mask_k)
    return _head_plain(norm_params, out_params, x, topk, gather_ids)


def _chain_cuda(stacked, norm_params, out_params, x_new, cache_k, cache_v, mem_k,
                mem_v, pos, n_head, anc, group, mem_mask, maskk, topk, gather_ids):
    """K3 on the card: one cooperative launch of decode_chain.cu
    `decode_chain_fused` (every stacked layer by its stride, no slicing
    here, then the head)."""
    _check_fused(cache_k, mem_k)
    for t, nm in ((norm_params["scale"], "norm scale"), (norm_params["bias"], "norm bias"),
                  (out_params["w"], "out_params w")):
        kernels.check(t, torch.float32, nm)
    x = kernels.check(x_new.contiguous(), torch.float32, "x_new")
    tensors, quant = stacked
    nl, K, B, Lpad, D = cache_k.shape
    BK = x.shape[0]
    V, Lk = out_params["w"].shape[1], mem_k.shape[2]
    if tuple(x.shape) != (K * B, D) or K != group or mem_k.shape[:2] != (nl, B):
        raise ValueError(f"decode_chain_step_flash: x_new {tuple(x.shape)}, caches "
                         f"{tuple(cache_k.shape)} and memory {tuple(mem_k.shape)} do not fit "
                         f"groups of {group}")
    FF = tensors[18 if quant else 12].shape[-1]
    plan = fused_plan(BK, D, FF, n_head, Lpad, Lk, quant, nl=nl, V=V, K=group, chain=True)
    ptrs = _fused_pointers(tensors, quant)
    dev = x.device
    sc = torch.empty((BK, topk), device=dev, dtype=torch.float32)
    ids = torch.empty((BK, topk), device=dev, dtype=torch.int32)
    gid = glp = None
    if gather_ids is not None:
        gid = kernels.check(gather_ids.to(torch.int32).contiguous(), torch.int32,
                            "gather_ids")
        glp = torch.empty((BK,), device=dev, dtype=torch.float32)
    ws = torch.empty((plan["ws_floats"],), device=dev, dtype=torch.float32)
    kernels.launch("decode_chain_fused", ctypes.addressof(ptrs), int(quant),
                   int(cache_k.dtype == torch.bfloat16), norm_params["scale"],
                   norm_params["bias"], out_params["w"], x, gid, anc, maskk, mem_mask, cache_k,
                   cache_v, mem_k, mem_v, sc, ids, glp, ws, _tiles_on(dev, BK, D, FF, V),
                   plan["ws_floats"], pos, BK, group, Lpad, Lk, D, FF, n_head, nl, V, topk,
                   plan["smem"], FUSED_GRID)
    return (sc, ids) if gid is None else (sc, ids, glp)


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
    also glp [BK], the log-prob at those ids. On the card one cooperative
    launch (`decode_chain_fused`). Launches are counted per variant (module
    docstring), with gather_ids under `gather_`."""
    if not x_new.is_cuda:
        return decode_chain_step_plain(stacked, norm_params, out_params, x_new,
                                       cache_k, cache_v, mem_k, mem_v, pos,
                                       n_head, anc, group, mem_mask,
                                       self_mask_k, topk, gather_ids)
    kernels.refuse_grad("decode_chain_step_flash", TRAINABLE, x_new, mem_k,
                        mem_v, *stacked[0], *norm_params.values(),
                        *out_params.values())
    _check_cuda_args(cache_k, cache_v, mem_k, mem_v, anc, self_mask_k, mem_mask)
    out = _chain_cuda(stacked, norm_params, out_params, x_new, cache_k, cache_v, mem_k,
                      mem_v, pos, n_head, anc, group, mem_mask, self_mask_k, topk,
                      gather_ids)
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
    x = _run_layers(stacked, x, cache_k, cache_v, mem_k, mem_v,
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
