"""The plain reference of the stjep configurations: the reference model
(EdieLu/speech-translation-joint-embedding-passing, models/Seq2seq.py and
its modules) written out in plain PyTorch float32, with no kernel, cache or
batching trick, for the benchmark's comparison. It imports nothing of the
program under test and takes only the weight tree and the inputs.

- LAS encoder: 4 pyramid BiLSTM layers with packed-sequence semantics
  (outputs zero and carries held past a row's valid frames), lengths
  x + 8 - x % 8 capped at T, adjacent frames concatenated between layers.
- LAS decoder, teacher forced: each step feeds [embedding of the given
  symbol ; previous dynamic embedding] through 3 residual uni-LSTMs
  (residual on the middle layers only), attends bilinearly over the
  pyramid output (keys past T_i/8 masked at -1e12), and emits the dynamic
  embedding FFN([context ; query]) and the head's logits.
- Source: [static ; dynamic] embeddings through the projection, masked by
  the LAS lengths (first EOS or PAD symbol + 1).
- Transformer: pre-LN layers, LayerNorm on the query input only, -1e9 on
  masked scores, the sinusoidal time signal and (universal: one shared
  layer, six hops) the layer signal before each hop; final LayerNorm eps
  1e-6 (encoder) and 1e-5 (decoder); vocabulary head without bias.
- Training loss: each head's masked NLL over its non-PAD targets, divided
  by their count; ASR_ST sums the ASR and ST heads, MT has the MT head; the
  gradient is clipped by its global norm (optax's rule) and applied by Adam
  (torch's defaults) written out. With `Drops` (the step's random draws,
  handed in as data) the regularisers act where the reference model puts
  them: SpecAugment's band mask on the features; inverted dropout at the
  configured rate on each pyramid layer's output, on the LAS decoder's
  LSTM outputs (after the residual) and attention context each step, after
  each attention's output projection and each FFN, before the residual;
  and at a fixed 0.1 on the attention probabilities.

Call `precise()` first: TF32 off, float32 matmuls at full precision.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

PAD, BOS, EOS = 0, 2, 3
ATTN_DROPOUT = 0.1  # the reference model's attention-probability rate, whatever the configured one


class Drops:
    """One training step's random draws in the order the step takes them:
    uniform draws in [0, 1) as (tensor, its batch dim), an element kept
    where its draw is under 1 - rate; and SpecAugment's keep mask [T, C]
    (or None). `rows` keeps the first rows of every draw's batch dim.
    Each `take` checks the draw's shape against the site's."""

    def __init__(self, draws, spec_keep=None, rate: float = 0.0, rows=None):
        self.draws, self.spec_keep, self.rate, self.rows = list(draws), spec_keep, rate, rows
        self.i = 0

    def take(self, shape, rate: float, device) -> torch.Tensor:
        """The inverted-dropout multiplier for the next draw, of `shape`."""
        u, bd = self.draws[self.i]
        self.i += 1
        if self.rows is not None:
            u = u.narrow(bd, 0, self.rows)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draw {self.i - 1} has shape {tuple(u.shape)}, the site {tuple(shape)}")
        keep = 1.0 - rate
        return (u.to(device) < keep).float() / keep

    def apply(self, x: torch.Tensor, rate: float = None) -> torch.Tensor:
        rate = self.rate if rate is None else rate
        return x * self.take(x.shape, rate, x.device) if rate > 0.0 else x

    def done(self):
        if self.i != len(self.draws):
            raise ValueError(f"{len(self.draws) - self.i} of {len(self.draws)} draws unused")


def _drop(drops, x, rate=None):
    return x if drops is None else drops.apply(x, rate)


def precise(tf32: bool = False):
    """TF32 off (or on, for the lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long()] * (ids != PAD)[..., None].to(table.dtype)


def signal(n: int, d: int, device) -> torch.Tensor:
    """[n, d] sinusoidal table: sin on even features, cos on odd ones,
    computed in float32 on the host."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, :pe[:, 1::2].shape[1]]
    return pe.to(device)


def _gates(pre, c, H):
    i, f, g, o = pre.split(H, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm(pf: Dict, pb: Dict, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Both directions over x [B, T, Din], zero past lens: [B, T, 2H]."""
    B, T, _ = x.shape
    H = pf["w_hh"].shape[0]
    w_ih = torch.stack([pf["w_ih"], pb["w_ih"]])
    w_hh = torch.stack([pf["w_hh"], pb["w_hh"]])
    bias = torch.stack([pf["b_ih"] + pf["b_hh"], pb["b_ih"] + pb["b_hh"]])
    xp = torch.einsum("btd,zdg->ztbg", x, w_ih) + bias[:, None, None, :]
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    outs_f, outs_b = [], []
    for s in range(T):
        t0, t1 = s, T - 1 - s
        pre = torch.stack([xp[0, t0], xp[1, t1]]) + torch.bmm(h, w_hh)
        hn, cn = _gates(pre, c, H)
        valid = torch.stack([t0 < lens, t1 < lens])[:, :, None]
        h = torch.where(valid, hn, h)
        c = torch.where(valid, cn, c)
        out = torch.where(valid, hn, torch.zeros_like(hn))
        outs_f.append(out[0])
        outs_b.append(out[1])
    return torch.cat([torch.stack(outs_f, 1), torch.stack(outs_b[::-1], 1)], dim=-1)


def las_encoder(p: Dict, cfg: Dict, feats: torch.Tensor, lens: torch.Tensor, drops=None):
    """(acoustic outputs [B, T/8, 2H], key lengths [B])."""
    B, T, _ = feats.shape
    lens = torch.clamp(lens.long() + 8 - lens.long() % 8, max=T)
    raw = lens
    x = feats
    if drops is not None and drops.spec_keep is not None:
        x = x * drops.spec_keep.to(x.device, x.dtype)
    n = cfg["num_pyramid_layers"]
    for i in range(n):
        layer = p[f"acous_enc_l{i + 1}"]
        out = _drop(drops, bilstm(layer["fwd"], layer["bwd"], x, lens))
        if i < n - 1:
            b, t, d = out.shape
            x = out.reshape(b, t // 2, 2 * d)
            lens = lens // 2
        else:
            x = out
    return x, raw


def las_decoder(p: Dict, cfg: Dict, acous: torch.Tensor, acous_lens: torch.Tensor,
                tokens: torch.Tensor, drops=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher forced on tokens [B, L] (BOS first): L - 1 steps, each fed
    tokens[:, step]. Returns (dynamic embeddings [B, L-1, D], logits
    [B, L-1, V])."""
    B, Tk, _ = acous.shape
    D = cfg["dim_model"]
    n = cfg["num_unilstm_dec"]
    m_lstm = m_ctx = None
    if drops is not None and drops.rate > 0.0:
        S = tokens.shape[1] - 1
        m_lstm = drops.take((S, n, B, D), drops.rate, acous.device)
        m_ctx = drops.take((S, B, 1, acous.shape[2]), drops.rate, acous.device)
    lens_k = (acous_lens.long() + 8 - acous_lens.long() % 8) // 8
    masked = torch.arange(Tk, device=acous.device)[None, :] >= lens_k[:, None]
    wk = acous @ p["acous_att"]["linear_att_w"]["w"]
    h = [acous.new_zeros((B, D)) for _ in range(n)]
    c = [acous.new_zeros((B, D)) for _ in range(n)]
    cell = acous.new_zeros((B, D))
    embs = []
    for step in range(tokens.shape[1] - 1):
        x = torch.cat([embed(p["embedder"], tokens[:, step]), cell], dim=-1)
        out = None
        for i in range(n):
            lp = p[f"dec_l{i}"]
            inp = x if i == 0 else out
            pre = inp @ lp["w_ih"] + h[i] @ lp["w_hh"] + lp["b_ih"] + lp["b_hh"]
            h[i], c[i] = _gates(pre, c[i], D)
            out = h[i] + out if 0 < i < n - 1 else h[i]
            if m_lstm is not None:
                out = out * m_lstm[step, i]
        scores = torch.einsum("bh,bkh->bk", out, wk)
        scores = torch.where(masked, torch.full_like(scores, -1e12), scores)
        ctx = torch.einsum("bk,bkv->bv", torch.softmax(scores, dim=-1), acous)
        if m_ctx is not None:
            ctx = ctx * m_ctx[step, :, 0]
        cell = torch.cat([ctx, out], dim=-1) @ p["acous_ffn"]["w"]
        embs.append(cell)
    embs = torch.stack(embs, dim=1)
    return embs, embs @ p["acous_out"]["w"] + p["acous_out"]["b"]


def lengths_from_symbols(sym: torch.Tensor, L: int) -> torch.Tensor:
    """First EOS or PAD at step j gives length j + 1, else L."""
    stop = (sym == EOS) | (sym == PAD)
    first = torch.argmax(stop.int(), dim=1)
    return torch.where(stop.any(dim=1), first + 1, torch.full_like(first, L))


def _layer_norm(p, x, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mha(p, q, kv, n_head, mask, drops=None):
    """Pre-LN attention on the query input, with the residual; mask
    [B, Lq|1, Lk], False = blocked."""
    B, Lq, D = q.shape
    d = D // n_head
    qn = _layer_norm(p["layer_norm"], q, 1e-6)
    Q = (qn @ p["w_qs"]["w"]).view(B, Lq, n_head, d)
    K = (kv @ p["w_ks"]["w"]).view(B, kv.shape[1], n_head, d)
    V = (kv @ p["w_vs"]["w"]).view(B, kv.shape[1], n_head, d)
    s = torch.einsum("bqnd,bknd->bnqk", Q / d ** 0.5, K)
    s = s.masked_fill(~mask[:, None], -1e9)
    a = _drop(drops, torch.softmax(s, -1), ATTN_DROPOUT)
    o = torch.einsum("bnqk,bknd->bqnd", a, V).reshape(B, Lq, D)
    return _drop(drops, o @ p["fc"]["w"]) + q


def _ffn(p, x, drops=None):
    y = _layer_norm(p["layer_norm"], x, 1e-6)
    y = torch.relu(y @ p["w_1"]["w"] + p["w_1"]["b"]) @ p["w_2"]["w"] + p["w_2"]["b"]
    return _drop(drops, y) + x


def _hops(cfg, n):
    return [0] * n if cfg["transformer_type"] == "universal" else list(range(n))


def tf_encoder(p: Dict, cfg: Dict, x: torch.Tensor, key_mask: torch.Tensor,
               drops=None) -> torch.Tensor:
    """x [B, L, D] embedded source, key_mask [B, L] True = attend."""
    L, D = x.shape[1], cfg["dim_model"]
    n = cfg["enc_layers"]
    x = x + signal(max(500, L), D, x.device)[:L]
    lsig = signal(n, D, x.device)
    mask = key_mask[:, None, :]
    for hop, li in enumerate(_hops(cfg, n)):
        if cfg["transformer_type"] == "universal":
            x = x + lsig[hop]
        lp = p["layers"][li]
        x = _ffn(lp["pos_ffn"], _mha(lp["slf_attn"], x, x, cfg["num_heads"], mask, drops), drops)
    return _layer_norm(p["norm"], x, 1e-6)


def tf_decoder_logits(params: Dict, cfg: Dict, tokens: torch.Tensor, memory: torch.Tensor,
                      mem_mask: torch.Tensor, drops=None) -> torch.Tensor:
    """Teacher-forced decoder over tokens [B, L] (causal, PAD keys masked):
    logits [B, L, V] (position t predicts token t + 1)."""
    p = params["dec_tgt"]
    B, L = tokens.shape
    D, n = cfg["dim_model"], cfg["dec_layers"]
    x = embed(params["dec_embedder"], tokens)
    if "dec_emb_proj" in params:
        x = x @ params["dec_emb_proj"]["w"]
    x = x + signal(max(500, L), D, x.device)[:L]
    lsig = signal(n, D, x.device)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    self_mask = (tokens != PAD)[:, None, :] & causal[None]
    cross = mem_mask[:, None, :]
    for hop, li in enumerate(_hops(cfg, n)):
        if cfg["transformer_type"] == "universal":
            x = x + lsig[hop]
        lp = p["layers"][li]
        x = _mha(lp["decslf_attn"], x, x, cfg["num_heads"], self_mask, drops)
        x = _mha(lp["encdec_attn"], x, memory, cfg["num_heads"], cross, drops)
        x = _ffn(lp["pos_ffn"], x, drops)
    return _layer_norm(p["norm"], x, 1e-5) @ params["out_tgt"]["w"]


def st_memory(params: Dict, cfg: Dict, static_ids: torch.Tensor, dyn: torch.Tensor,
              lengths: torch.Tensor, drops=None):
    """The encoder memory of ST from the source symbols [B, Ls] and their
    dynamic embeddings: ([B, Ls, D], key mask [B, Ls])."""
    emb = torch.cat([embed(params["enc_embedder"], static_ids), dyn], dim=2)
    emb = emb @ params["enc_emb_proj"]["w"]
    key_mask = torch.arange(emb.shape[1], device=emb.device)[None, :] < lengths[:, None]
    return tf_encoder(params["enc_src"], cfg, emb, key_mask, drops), key_mask


# ---------------------------------------------------------------- training


def _masked_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, targets.long()[..., None])[..., 0]
    m = (targets != PAD).to(logits.dtype)
    return -(picked * m).sum() / torch.clamp(m.sum(), min=1.0)


def train_losses(params: Dict, cfg: Dict, mode: str, batch: Dict,
                 drops: Drops = None) -> Dict[str, torch.Tensor]:
    """The heads' losses of one step, with the step's draws where `drops`
    has them: {"nll_loss_en", "nll_loss_de"}, 0.0 for a head the mode
    lacks."""
    src, tgt = batch["srcid"], batch["tgtid"]
    out = {"nll_loss_en": torch.zeros((), device=src.device)}
    if mode == "ASR_ST":
        acous, _ = las_encoder(params["las"]["encoder"], cfg, batch["acous_feat"],
                               batch["acouslen"], drops)
        dyn, logits = las_decoder(params["las"]["decoder"], cfg, acous, batch["acouslen"], src,
                                  drops)
        out["nll_loss_en"] = _masked_nll(logits, src[:, 1:])
        lengths = lengths_from_symbols(torch.argmax(logits, dim=-1), src.shape[1])
        memory, key_mask = st_memory(params, cfg, src[:, 1:], dyn, lengths, drops)
    elif mode == "MT":
        trim = src[:, 1:]
        dyn = params["emb_dyn_ave"].detach()[None, None, :].expand(
            trim.shape[0], trim.shape[1], cfg["dim_model"])
        emb = torch.cat([embed(params["enc_embedder"], trim), dyn], dim=2)
        key_mask = trim != PAD
        memory = tf_encoder(params["enc_src"], cfg, emb @ params["enc_emb_proj"]["w"], key_mask,
                            drops)
    else:
        raise ValueError(f"no reference for mode {mode}")
    logits = tf_decoder_logits(params, cfg, tgt, memory, key_mask, drops)
    out["nll_loss_de"] = _masked_nll(logits[:, :-1], tgt[:, 1:])
    if drops is not None:
        drops.done()
    return out


def grads_of(params_leaves: List[torch.Tensor], loss: torch.Tensor) -> List[torch.Tensor]:
    gs = torch.autograd.grad(loss, params_leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params_leaves, gs)]


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if float(norm) < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8), written out."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + eps))
