"""K2: the free-running LAS greedy decoder (port of
stjep_tpu/ops/las_flash.py `las_greedy_flash`), and the plan K2 and K9 share.

On CUDA tensors `las_greedy_flash` is one cooperative persistent launch of
`csrc/las_fused.cu` (`las_greedy_fused`) over all the steps; the emitted
symbol never leaves the card. On CPU tensors `las_greedy_plain` runs the
same function in plain PyTorch, step for step as the JAX package's XLA scan
(`las_decoder_forward` with `want_logps=False`), through the LAS decoder's
step loop.

`las_plan` and `las_tiles` describe a launch of K2 or K9 (ops/
las_tf_flash.py) from the shapes alone: the work items of each phase, the
phases and grid barriers of a call, the shared memory a block takes and the
workspace. The kernels walk the item table `las_tiles` builds, passed to
them as `tiles`; `las_fused.cu` computes the same workspace layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.utils.weak

from stjep_tpu_torch import kernels
from stjep_tpu_torch.bridge import leaves


def las_flash_supported(cfg) -> bool:
    """The widths and attention mode the kernel takes, as JAX's
    `las_flash_supported` (stjep_tpu/ops/las_flash.py:64-72): bilinear
    attention (the recipe's mode) and tile-friendly widths."""
    return (cfg.acous_att_mode == "bilinear" and cfg.enc_embedding_size % 8 == 0
            and cfg.dim_model % 128 == 0 and (2 * cfg.acous_hidden_size) % 128 == 0)


# ---------------------------------------------------------------------------
# the plan of a fused K2 / K9 launch (csrc/las_fused.cu)
# ---------------------------------------------------------------------------

# item kinds of the table, in las_fused.cu's order (I_LSTM ..)
LAS_KINDS = ("lstm", "att", "ffn", "head", "ffn_t", "lstm_t", "l0_t")
LAS_THREADS = 256
LAS_BM = 16  # rows of an item
LAS_NJ = 8  # columns of a narrow item: 2 hidden units x 4 gates, 8 FFN columns
LAS_UNITS = LAS_NJ // 4
LAS_NKC = 256  # contraction depth of a narrow chunk
LAS_WJ = 128  # ids of a head item
LAS_DEPTH = 4  # chunks in flight, a ring of shared-memory stages
LAS_KEYS = 16  # keys of an attention chunk
LAS_SMEM_MAX = 232448 - 1024  # what an H100 block may opt in to, less the kernels' static bytes
_STAGE = (LAS_NJ + LAS_BM) * (LAS_NKC + 4)  # floats of a shared-memory stage
_RED = LAS_THREADS // 32 * LAS_BM * LAS_NJ
# blocks of a fused K2 / K9 launch; 0 launches every block the card keeps
# resident (the card tests set it to hold the outputs independent of the grid)
LAS_GRID = 0
_KIND_IDS = {"greedy": 0, "tf_fwd": 1, "tf_bwd": 2}


def key_chunks(Tk: int) -> Tuple[int, int]:
    """(keys a chunk, chunks a row) of the attention phases."""
    return LAS_KEYS, -(-Tk // LAS_KEYS)


def _items(kind: str, B: int, Tk: int, Hd: int, Hs: int, Ha2: int, V: int) -> Dict:
    """{item kind: [(a, b, c, d)]}: LSTM items (first row, first unit),
    attention items (row, first key, end key, chunk), the others (first row,
    first column)."""
    rows = range(0, B, LAS_BM)
    tc, _ = key_chunks(Tk)
    cols = lambda n, w: [(r, c, 0, 0) for r in rows for c in range(0, n, w)]
    out = {k: [] for k in LAS_KINDS}
    out["att"] = [(b, t0, min(t0 + tc, Tk), c) for b in range(B)
                  for c, t0 in enumerate(range(0, Tk, tc))]
    if kind in ("greedy", "tf_fwd"):
        out["lstm"] = cols(Hd, LAS_UNITS)
        out["ffn"] = cols(Hs, LAS_NJ)
        if kind == "greedy":
            out["head"] = cols(V, LAS_WJ)
    else:
        out["ffn_t"] = cols(Ha2 + Hd, LAS_NJ)
        out["lstm_t"] = cols(2 * Hd, LAS_NJ)
        out["l0_t"] = cols(Hs + Hd, LAS_NJ)
    return out


def las_tiles(kind: str, B: int, Tk: int, Hd: int, Hs: int, Ha2: int,
              V: int = 0) -> torch.Tensor:
    """The item table the fused K2 / K9 walk (`tiles`): int32, 8 offsets
    (the first item of each kind of LAS_KINDS, then the end), then 4 ints an
    item, a kind's items one after another."""
    items = _items(kind, B, Tk, Hd, Hs, Ha2, V)
    rows, off = [], []
    for k in LAS_KINDS:
        off.append(len(rows))
        rows += items[k]
    off.append(len(rows))
    return torch.tensor(off + [v for row in rows for v in row], dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _tiles_on(device, kind: str, B: int, Tk: int, Hd: int, Hs: int, Ha2: int,
              V: int) -> torch.Tensor:
    return las_tiles(kind, B, Tk, Hd, Hs, Ha2, V).to(device)


def _ws_regions(kind: str, B: int, Tk: int, Hd: int, Hs: int, Ha2: int, V: int,
                nl: int) -> Dict[str, int]:
    """The workspace's regions in floats, each rounded up to a multiple of
    4, in las_fused.cu `lay` order."""
    _, nc = key_chunks(Tk)
    r: Dict[str, int] = {}
    if kind == "greedy":
        P = -(-V // LAS_WJ)
        r.update(X0=2 * B * (Hs + Hd), XL=(nl - 1) * 2 * B * 2 * Hd, C=nl * B * Hd,
                 FF=B * (Ha2 + Hd), HM=P * B, HI=P * B, HS=P * B, REF=B)
    if kind == "tf_bwd":
        r.update(DH=3 * B * Hd, DC=3 * B * Hd, DY1=B * Hd, DFFQ=B * Hd, AS=B * nc,
                 AP1=B * nc * Hd, AP2=B * nc * Hd, DATT=B * Tk)
    else:
        r.update(AM=B * nc, AZ=B * nc, ACTX=B * nc * Ha2, SC=B * Tk)
    r["CNT"] = B
    return {k: -(-v // 4) * 4 for k, v in r.items()}  # regions start 16-byte aligned


@functools.lru_cache(maxsize=128)
def las_plan(kind: str, B: int, Tk: int, Hd: int, Hs: int, Ha2: int, E: int = 0, V: int = 0,
             nl: int = 3, steps: int = 1) -> Dict:
    """A launch of K2 (kind "greedy", nl layers, `steps` free-running steps
    over V ids) or of K9's forward ("tf_fwd") or backward ("tf_bwd") over
    `steps` steps, from the shapes alone: `items` {item kind: count},
    `phases` [(name, work items)] of the whole call in order (a grid
    barrier between each two), `barriers`, `tc` and `nc` (keys a chunk,
    chunks a row), `smem` (dynamic shared bytes a block), `regions` and
    `ws_floats` (f32 workspace). Cached: the wrappers ask it at every
    launch; treat the result as read-only."""
    items = {k: len(v) for k, v in _items(kind, B, Tk, Hd, Hs, Ha2, V).items()}
    if kind == "greedy":
        step = [("lstm", items["lstm"])] * nl + [("att", items["att"]), ("ffn", items["ffn"]),
                                                 ("head", items["head"])]
        phases = step * steps + [("outputs", B)]
    elif kind == "tf_fwd":
        phases = ([("lstm", items["lstm"])] * 3 + [("att", items["att"]),
                                                   ("ffn", items["ffn"])]) * steps
    else:
        step = [("ffn_t", items["ffn_t"]), ("att", items["att"]), ("lstm_t", items["lstm_t"]),
                ("lstm_t", items["lstm_t"])]
        phases = (step + [("l0_t", items["l0_t"])]) * (steps - 1) + step
    tc, nc = key_chunks(Tk)
    # an attention item's rows: its query (or dctx) row, its chunk's keys and
    # values, scores (and attention weights), the merge's chunk factors
    att = (Ha2 + tc * (Ha2 + Hd) + 2 * tc if kind == "tf_bwd"
           else Hd + tc * (Hd + Ha2) + tc + nc)
    smem = 4 * (max(LAS_DEPTH * _STAGE, att) + _RED + LAS_BM * LAS_NJ)
    regions = _ws_regions(kind, B, Tk, Hd, Hs, Ha2, V, nl)
    return dict(items=items, phases=phases, barriers=len(phases) - 1, tc=tc, nc=nc, smem=smem,
                regions=regions, ws_floats=sum(regions.values()))


def las_grid(kind: str, smem: int) -> Dict[str, int]:
    """The card's answer for a fused K2 / K9 launch at smem bytes: blocks an
    SM keeps resident and the SM count (their product is the grid)."""
    out = (ctypes.c_int * 2)()
    kernels.launch("las_fused_grid", _KIND_IDS[kind], smem, ctypes.addressof(out))
    return dict(blocks_per_sm=out[0], sms=out[1], blocks=out[0] * out[1])


def check_widths(B: int, Tk: int, Hd: int, Hs: int, Ha2: int, E: int = 0, ws_floats: int = 0,
                 smem: int = 0):
    """Raise, before a launch, for shapes the fused kernels do not take."""
    bad = []
    if B < 1 or Tk < 1:
        bad.append(f"B = {B} and Tk = {Tk} must be >= 1")
    if Hd % 4 or Hs % 8 or Ha2 % 4 or E % 4:
        bad.append(f"Hd = {Hd}, Ha2 = {Ha2}, E = {E} must be multiples of 4 and Hs = {Hs} "
                   "of 8 (16-byte weight rows)")
    if ws_floats >= 2 ** 31:
        bad.append(f"the workspace ({ws_floats} floats) must be below 2^31")
    if smem > LAS_SMEM_MAX:
        bad.append(f"a block would need {smem} bytes of shared memory, above the "
                   f"{LAS_SMEM_MAX} an H100 block may take (the attention stages "
                   f"{LAS_KEYS} keys x (Hd + Ha2) floats)")
    if bad:
        raise ValueError("the fused LAS kernels cannot run this shape: " + "; ".join(bad))


def pack_gates(w: torch.Tensor) -> torch.Tensor:
    """[K, 4H] with gate blocks (i, f, g, o) -> [K, 4H] with a unit's four
    gates adjacent: column 4u + g holds column g * H + u."""
    K, G = w.shape
    return w.reshape(K, 4, G // 4).transpose(1, 2).reshape(K, G).contiguous()


# packed K2 weights, kept as long as the params' first LSTM matrix lives
_PACKED = torch.utils.weak.WeakIdKeyDictionary()


def _greedy_weights(params: Dict, nl: int):
    """The nl layers' packed [W_ih ; W_hh], stacked, and their b_ih + b_hh
    [nl, 4Hd]: a decode calls K2 with the same weights every time, so they
    are packed once and kept until those tensors change (object, storage
    or in-place version) or dec_l0.w_ih is freed."""
    srcs = tuple(params[f"dec_l{i}"][k] for i in range(nl)
                 for k in ("w_ih", "w_hh", "b_ih", "b_hh"))
    key = tuple((id(t), t.data_ptr(), t._version) for t in srcs)
    hit = _PACKED.get(srcs[0])
    if hit is None or hit[0] != key:
        w = torch.cat([pack_gates(torch.cat([srcs[4 * i], srcs[4 * i + 1]], 0)).reshape(-1)
                       for i in range(nl)])
        b = torch.stack([srcs[4 * i + 2] + srcs[4 * i + 3] for i in range(nl)]).contiguous()
        hit = _PACKED[srcs[0]] = (key, w, b)
    return hit[1], hit[2]


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def las_greedy_plain(params: Dict, cfg, wk: torch.Tensor,
                     att_values: torch.Tensor, lens_k: torch.Tensor,
                     sym0: torch.Tensor, n_steps: int,
                     ref_tokens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the LAS decoder's step loop
    (models/las_decoder.py `_step_loop`) free running on the bilinear keys
    wk. Returns (embs [B, n, Hs], preds [B, n] int64, picked [B, n]): the
    dynamic embeddings, the greedy symbols, and the log-softmax at
    ref_tokens[:, step] (token 0 without refs)."""
    from stjep_tpu_torch.models.las_decoder import _att_mask, _step_loop

    dev = wk.device
    return _step_loop(params, cfg, att_values.to(dev), _att_mask(lens_k.to(dev), wk.shape[1]),
                      n_steps, sym0=sym0.to(dev).long(), ref_tokens=ref_tokens,
                      pre_keys={"wk": wk}, mode="bilinear")


def las_greedy_flash(params: Dict, cfg, wk: torch.Tensor,
                     att_values: torch.Tensor, lens_k: torch.Tensor,
                     sym0: torch.Tensor, n_steps: int,
                     ref_tokens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the free-running decode: wk [B, Tk, Hd] precomputed bilinear key
    projections, att_values [B, Tk, 2Ha], lens_k [B] valid key positions,
    sym0 [B] first input symbol, ref_tokens [B, n] or None.
    Returns (embs [B, n, Hs], preds [B, n] int64, picked [B, n])."""
    if not wk.is_cuda:
        return las_greedy_plain(params, cfg, wk, att_values, lens_k, sym0,
                                n_steps, ref_tokens)
    kernels.refuse_grad("las_greedy_flash",
                        "the teacher-forced LAS decoder (las_tf_scan)",
                        wk, att_values, *leaves(params))
    dev = wk.device
    B, Tk, Hd = wk.shape
    Ha2 = att_values.shape[-1]
    E, nl = cfg.enc_embedding_size, cfg.num_unilstm_dec
    table = params["embedder"]
    w_ffn = params["acous_ffn"]["w"]
    w_out, b_out = params["acous_out"]["w"], params["acous_out"]["b"]
    Hs, V = w_ffn.shape[1], w_out.shape[1]
    if n_steps < 1:
        raise ValueError(f"las_greedy_flash: n_steps = {n_steps} must be >= 1")
    plan = las_plan("greedy", B, Tk, Hd, Hs, Ha2, E=E, V=V, nl=nl, steps=n_steps)
    check_widths(B, Tk, Hd, Hs, Ha2, E, plan["ws_floats"], plan["smem"])
    for t_, nm in ((wk, "wk"), (att_values, "att_values"), (table, "embedder"),
                   (w_ffn, "acous_ffn"), (w_out, "acous_out.w"), (b_out, "acous_out.b")):
        kernels.check(t_, name=nm)
    refs = None
    if ref_tokens is not None:
        refs = ref_tokens.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(refs.shape) != (B, n_steps):
            raise ValueError(f"ref_tokens must be [{B}, {n_steps}], got {tuple(refs.shape)}")
    w, b = _greedy_weights(params, nl)
    lens = lens_k.to(device=dev, dtype=torch.int64).contiguous()
    sym = sym0.to(device=dev, dtype=torch.int64).contiguous()
    embs = torch.empty((B, n_steps, Hs), device=dev, dtype=torch.float32)
    preds = torch.empty((B, n_steps), device=dev, dtype=torch.int64)
    picked = torch.empty((B, n_steps), device=dev, dtype=torch.float32)
    ws = torch.empty((plan["ws_floats"],), device=dev, dtype=torch.float32)
    kernels.launch("las_greedy_fused", table, sym, refs, w, b, w_ffn, w_out, b_out, wk,
                   att_values, lens, embs, preds, picked, ws,
                   _tiles_on(dev, "greedy", B, Tk, Hd, Hs, Ha2, V), plan["ws_floats"], B, Tk, E,
                   Hd, Hs, Ha2, V, nl, n_steps, plan["nc"], plan["tc"], plan["smem"], LAS_GRID)
    las_greedy_flash.launches += 1
    return embs, preds, picked


las_greedy_flash.launches = 0
