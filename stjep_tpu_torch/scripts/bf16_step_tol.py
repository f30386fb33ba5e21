#!/usr/bin/env python3
"""How far the fused K6b with bf16 memory may sit from its plain version, on the CPU.

    python3 stjep_tpu_torch/scripts/bf16_step_tol.py [--seeds 8] [--limit 1e-3]

With bf16 memory K/V the cross-attention step rounds the scaled query to
bf16 and each q.k product to bf16 (csrc/attend.cuh). The fused K6b
(csrc/decode_fused.cu) sums its query's products split by split in split
order, the plain version (ops/decode_flash.py `cross_attn_step_plain`) by
one matmul, so a few query entries round to the neighbouring bf16 value:
the two differ by more than f32 summation order alone gives. This script
puts a number on that at chip_smoke.py's bf16 shapes (flagship widths,
layer 0's weights from init_seq2seq(seed 0), one shard of 2: Dq 256, 4
local heads, B=16 x beam 5, memory of 89 rows padded to 96 from
chip_smoke.py's decode_state). For each seed it builds the kernel's order
in plain PyTorch (LN(x) @ w_qs and ctx @ fc as 64-deep split partials
summed in order; attention rounded as the kernel rounds) and three faults
(the query not rounded, the products not rounded, the probabilities
rounded to bf16), and prints each one's largest distance from the plain
version. A limit for chip_smoke.py's `cross_attn bf16` row must sit above
every seed's honest distance and below every fault's. Exits 1 where
--limit does not.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402

FAULTS = {"honest": {}, "query not rounded": dict(q_round=False),
          "products not rounded": dict(prod_round=False),
          "probabilities rounded": dict(p_round=True)}


def split_k(a, w, kc=64):
    """a @ w as kc-deep partials summed in split order (the fused kernels'
    order)."""
    acc = a[:, :kc] @ w[:kc]
    for s in range(kc, a.shape[1], kc):
        acc = acc + a[:, s:s + kc] @ w[s:s + kc]
    return acc


def attend(q, mk, mv, valid, n_head, q_round=True, prod_round=True, p_round=False):
    """Cross attention of q [BK, Dq] over bf16 mk/mv [BK, L, Dq] with the
    kernel's roundings, each of which a fault may switch."""
    BK, L, Dq = mk.shape
    d = Dq // n_head
    qh = q.view(BK, n_head, d) / d ** 0.5
    if q_round:
        qh = qh.to(torch.bfloat16).float()
    prod = qh[:, None] * mk.float().view(BK, L, n_head, d)
    if prod_round:
        prod = prod.to(torch.bfloat16).float()
    s = prod.sum(-1).transpose(1, 2).masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, -1)
    if p_round:
        p = p.to(torch.bfloat16).float()
    return torch.einsum("rnl,rlnd->rnd", p, mv.float().view(BK, L, n_head, d)).reshape(BK, Dq)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--limit", type=float, default=1e-3)
    args = ap.parse_args()
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.transformer import layer_norm

    cfg = ModelConfig(**cs.FLAGSHIP)
    params = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cpu")
    n, K, pos = 2, cs.BEAM, cs.DECODE_LEN // 2
    Dq, nh = cfg.dim_model // n, cfg.num_heads // n
    full = params["dec_tgt"]["layers"][0]["encdec_attn"]
    p = {"layer_norm": full["layer_norm"], "w_qs": {"w": full["w_qs"]["w"][:, :Dq].contiguous()},
         "fc": {"w": full["fc"]["w"][:Dq].contiguous()}}
    worst = {k: [] for k in FAULTS}
    for seed in range(args.seeds):
        rng = np.random.RandomState(seed)
        st = cs.decode_state(params, cfg, rng, pos, device="cpu")
        mm = st["mem_mask"]
        mk, mv = (t[0][..., :Dq].to(torch.bfloat16) for t in (st["cache"].mem_k,
                                                              st["cache"].mem_v))
        x = torch.from_numpy(rng.randn(cs.B * K, cfg.dim_model).astype(np.float32))
        plain = df.cross_attn_step_plain(p, x, mk, mv, nh, K, mm, False)
        b = torch.arange(cs.B * K) // K
        q = split_k(layer_norm(p["layer_norm"], x, 1e-6), p["w_qs"]["w"])
        row = {}
        for name, kw in FAULTS.items():
            y = split_k(attend(q, mk[b], mv[b], mm.T[b] != 0, nh, **kw), p["fc"]["w"])
            row[name] = float((y - plain).abs().max())
            worst[name].append(row[name])
        print(f"seed {seed} " + " ".join(f"{k.replace(' ', '_')}={v!r}" for k, v in row.items()),
              flush=True)
    honest = max(worst["honest"])
    fault = min(min(v) for k, v in worst.items() if k != "honest")
    ok = honest < args.limit < fault
    print(f"largest honest distance {honest!r}, smallest fault distance {fault!r}, "
          f"limit {args.limit!r}: {'separates' if ok else 'does not separate'} them")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
