"""Weights drawn from the seed on the device, in the port's parameter tree
(the key paths, shapes and layout of stjep_tpu_torch.models.seq2seq
init_seq2seq and bridge.py: `[in, out]` matrices, LSTM gates (i, f, g, o)).

Distributions follow the reference's defaults: N(0, 1) embeddings with the
PAD row zero, torch.nn.Linear's and torch.nn.LSTM's uniform bounds,
LayerNorms at one and zero. Every uniform leaf comes from one draw and
every normal leaf from another, on a torch.Generator on the device, in
float32; each leaf is then its own tensor. The same tree is handed to the
program and to the plain reference.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

PAD = 0


def _spec(cfg: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, kind, bound) of every leaf, kind one of uniform,
    normal, ones, zeros."""
    E, D, F = cfg["enc_embedding_size"], cfg["dim_model"], cfg["dim_feedforward"]
    Ha, Ve, Vd = cfg["acous_hidden_size"], cfg["enc_vocab_size"], cfg["dec_vocab_size"]
    Edec = cfg["dec_embedding_size"]
    out = []

    def linear(path, i, o, bias=True):
        out.append((f"{path}/w", (i, o), "uniform", math.sqrt(1.0 / i) * math.sqrt(3.0)))
        if bias:
            out.append((f"{path}/b", (o,), "uniform", 1.0 / math.sqrt(i)))

    def lstm(path, i, h):
        k = 1.0 / math.sqrt(h)
        for name, shape in (("w_ih", (i, 4 * h)), ("w_hh", (h, 4 * h)), ("b_ih", (4 * h,)),
                            ("b_hh", (4 * h,))):
            out.append((f"{path}/{name}", shape, "uniform", k))

    def norm(path, d):
        out.append((f"{path}/scale", (d,), "ones", 0.0))
        out.append((f"{path}/bias", (d,), "zeros", 0.0))

    def mha(path):
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            linear(f"{path}/{name}", D, D, bias=False)
        norm(f"{path}/layer_norm", D)

    def ffn(path):
        linear(f"{path}/w_1", D, F)
        linear(f"{path}/w_2", F, D)
        norm(f"{path}/layer_norm", D)

    out.append(("enc_embedder", (Ve, E), "normal", 0.0))
    out.append(("dec_embedder", (Vd, Edec), "normal", 0.0))
    linear("enc_emb_proj", E + D, D, bias=False)
    if Edec != D:
        linear("dec_emb_proj", Edec, D, bias=False)
    din = cfg["acous_dim"]
    for i in range(cfg["num_pyramid_layers"]):
        for side in ("fwd", "bwd"):
            lstm(f"las/encoder/acous_enc_l{i + 1}/{side}", din, Ha)
        din = 4 * Ha
    out.append(("las/decoder/embedder", (Ve, E), "normal", 0.0))
    linear("las/decoder/acous_att/linear_att_w", 2 * Ha, D, bias=False)
    linear("las/decoder/acous_ffn", 2 * Ha + D, D, bias=False)
    linear("las/decoder/acous_out", D, Ve)
    lstm("las/decoder/dec_l0", E + D, D)
    for i in range(1, cfg["num_unilstm_dec"]):
        lstm(f"las/decoder/dec_l{i}", D, D)
    n = 1 if cfg["transformer_type"] == "universal" else None
    for i in range(n or cfg["enc_layers"]):
        mha(f"enc_src/layers/{i}/slf_attn")
        ffn(f"enc_src/layers/{i}/pos_ffn")
    norm("enc_src/norm", D)
    for i in range(n or cfg["dec_layers"]):
        mha(f"dec_tgt/layers/{i}/decslf_attn")
        mha(f"dec_tgt/layers/{i}/encdec_attn")
        ffn(f"dec_tgt/layers/{i}/pos_ffn")
    norm("dec_tgt/norm", D)
    linear("out_tgt", D, Vd, bias=False)
    out.append(("emb_dyn_ave", (D,), "zeros", 0.0))
    return out


def _insert(tree: Dict, path: str, value):
    """Set tree[a][b]... along path; numeric parts make lists (the port's
    `layers` lists)."""
    parts = path.split("/")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if isinstance(node, list):
            p = int(p)
            while len(node) <= p:
                node.append([] if nxt.isdigit() else {})
            node = node[p]
        else:
            node = node.setdefault(p, [] if nxt.isdigit() else {})
    last = parts[-1]
    if isinstance(node, list):
        node.append(value)
    else:
        node[last] = value


def generator_seed(seed: int) -> int:
    """A 63-bit generator seed in which every bit of `seed` counts (a CPU
    torch.Generator keeps only the low 32 bits of what it is given)."""
    digest = hashlib.sha256(str(int(seed)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw_params(cfg: Dict, seed: int, device) -> Dict:
    """The parameter tree for `cfg` (the configuration file's sizes) drawn
    from `seed` on `device`: two draws in all (uniform, normal)."""
    spec = _spec(cfg)
    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    n_u = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    n_n = sum(math.prod(s) for _, s, k, _ in spec if k == "normal")
    flat_u = torch.rand((n_u,), generator=gen, device=device)
    flat_n = torch.randn((n_n,), generator=gen, device=device)
    tree: Dict = {}
    iu = inn = 0
    for path, shape, kind, bnd in spec:
        n = math.prod(shape)
        if kind == "uniform":
            t = (flat_u[iu:iu + n] * (2 * bnd) - bnd).view(shape)
            iu += n
        elif kind == "normal":
            t = flat_n[inn:inn + n].view(shape).clone()
            t[PAD] = 0.0
            inn += n
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        _insert(tree, path, t.contiguous())
    del flat_u, flat_n
    return tree


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs depth first in insertion order (bridge.named_leaves'
    order and naming)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]
