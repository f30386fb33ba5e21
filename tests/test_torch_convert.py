"""The port's reference-checkpoint converter against the JAX package's.

The reference package is not importable here, so the test builds the
reference's named parameters itself, by inverting the JAX converter's
layout rules on a JAX init (`reference_names`); JAX's own
convert_named_params must turn them back into that init (a round trip
that checks the inverse), and the port's conversion must then equal JAX's
bit for bit, leaf by leaf, for the standard, universal and ACT models (the
standard one with the reference's unused template modules present, which
both drop, and share_embedder, whose table torch names once). The script
stjep_tpu_torch/scripts/convert_torch_checkpoint.py runs end to end on a
stand-in reference package written here (a module `models.Seq2seq` whose
pickled Seq2seq carries those named parameters): it unpickles model.pt and
the dill vocabularies and writes a checkpoint that the port's translate
CLI loads back to the converted tree. The real reference package's
unpickling is left untested.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.train.convert import convert_named_params as jax_convert
from stjep_tpu_torch.bridge import named_leaves
from stjep_tpu_torch.train.convert import convert_named_params, convert_torch_model

REPO = Path(__file__).resolve().parents[1]
BASE = ModelConfig(
    enc_vocab_size=20, dec_vocab_size=18, enc_embedding_size=8, dec_embedding_size=16,
    acous_dim=6, acous_hidden_size=5, dim_model=16, dim_feedforward=32, num_heads=4,
    enc_layers=2, dec_layers=2, mode="ASR_ST", max_seq_len_src=10, max_seq_len_tgt=12)
CFGS = {"standard": BASE,
        "universal": dataclasses.replace(BASE, transformer_type="universal"),
        "act": dataclasses.replace(BASE, transformer_type="universal", act=True,
                                   dec_embedding_size=8),  # dec_emb_proj by size
        "shared": dataclasses.replace(BASE, share_embedder=True, dec_vocab_size=20)}
_LSTM = {"w_ih": ("weight_ih_l0", True), "w_hh": ("weight_hh_l0", True),
         "b_ih": ("bias_ih_l0", False), "b_hh": ("bias_hh_l0", False)}


def reference_names(tree, cfg):
    """{reference parameter name: array} of a JAX params tree: the inverse
    of the converter's layout rules (the torch module tree of the
    reference's Seq2seq)."""
    named = {}
    for path, leaf in named_leaves(tree):
        parts = path.strip("/").split("/")
        if parts == ["emb_dyn_ave"]:
            continue  # a buffer, not a parameter
        if cfg.share_embedder and parts == ["dec_embedder"]:
            continue  # torch names the shared module once
        arr = np.asarray(leaf)
        if parts[-1].endswith("embedder"):
            named[".".join(parts) + ".weight"] = arr
            continue
        leaf_name, mod = parts[-1], parts[:-1]
        if leaf_name in _LSTM:
            name, transpose = _LSTM[leaf_name]
            if mod[-1] in ("fwd", "bwd"):
                name += "_reverse" if mod[-1] == "bwd" else ""
                mod = mod[:-1]
            mod = [x for p in mod for x in (["dec", p[4:]] if p.startswith("dec_l") else [p])]
            named[".".join(mod + [name])] = arr.T if transpose else arr
            continue
        if len(mod) >= 2 and mod[0] in ("enc_src", "dec_tgt") and mod[1] == "layers":
            stem = mod[0][:3]
            mod = ([mod[0], stem] if cfg.transformer_type == "universal"
                   else [mod[0], f"{stem}_layers", mod[2]]) + mod[3:]
        name = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}[leaf_name]
        named[".".join(mod + [name])] = arr.T if leaf_name == "w" else arr
    if cfg.transformer_type == "standard":  # the unused template modules
        for owner, stem in (("enc_src", "enc"), ("dec_tgt", "dec")):
            named[f"{owner}.{stem}.pos_ffn.w_1.weight"] = np.full((32, 16), 7.0, np.float32)
    return named


def _same_tree(a, b):
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("kind", list(CFGS))
def test_conversion_bit_equal_to_jax(kind):
    cfg = CFGS[kind]
    init = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(3), cfg))
    dyn = np.random.RandomState(0).randn(cfg.dim_model).astype(np.float32)
    init["emb_dyn_ave"] = dyn
    named = reference_names(init, cfg)
    ref = jax.tree_util.tree_map(np.asarray, jax_convert(named, cfg, emb_dyn_ave=dyn))
    _same_tree(ref, init)  # the inverse is right
    ours = convert_named_params(named, cfg, emb_dyn_ave=dyn)
    assert all(isinstance(t, torch.Tensor) for _, t in named_leaves(ours))
    _same_tree(ours, ref)
    if cfg.share_embedder:
        assert ours["dec_embedder"].data_ptr() != ours["enc_embedder"].data_ptr()


class _Module(torch.nn.Module):
    """A module with the given named parameters (and EMB_DYN_AVE)."""

    def __init__(self, named, dyn):
        super().__init__()
        self._names = {}
        for i, (n, a) in enumerate(named.items()):
            self.register_parameter(f"p{i}", torch.nn.Parameter(torch.from_numpy(a.copy())))
            self._names[f"p{i}"] = n
        self.EMB_DYN_AVE = torch.from_numpy(dyn)

    def named_parameters(self, *a, **kw):
        for n, p in super().named_parameters(*a, **kw):
            yield self._names[n], p


def test_convert_torch_model_reads_the_buffer():
    cfg = CFGS["act"]
    init = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(4), cfg))
    dyn = np.arange(cfg.dim_model, dtype=np.float32)
    out = convert_torch_model(_Module(reference_names(init, cfg), dyn), cfg)
    init["emb_dyn_ave"] = dyn
    _same_tree(out, init)


STAND_IN = '''
import torch


class Seq2seq(torch.nn.Module):
    """Stand-in for the reference Seq2seq: its attributes and named
    parameters, nothing else."""

    def __init__(self, named, attrs):
        super().__init__()
        self.enc_embedder = self.dec_embedder = None
        self._names = {}
        for i, (n, a) in enumerate(named.items()):
            self.register_parameter(f"p{i}", torch.nn.Parameter(torch.as_tensor(a)))
            self._names[f"p{i}"] = n
        for k, v in attrs.items():
            setattr(self, k, v)

    def named_parameters(self, *a, **kw):
        for n, p in super().named_parameters(*a, **kw):
            yield self._names[n], p
'''


def test_script_converts_a_pickled_checkpoint(tmp_path):
    """The script's whole path on a stand-in reference package: the
    checkpoint it writes loads through the translate CLI's loader to the
    converted tree, with the vocabularies and emb_dyn_ave given."""
    import dill

    from stjep_tpu_torch.cli.translate import _load_model

    cfg = CFGS["act"]
    ref_root = tmp_path / "reference"
    (ref_root / "models").mkdir(parents=True)
    (ref_root / "models" / "__init__.py").write_text("")
    (ref_root / "models" / "Seq2seq.py").write_text(STAND_IN)
    init = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(5), cfg))
    named = reference_names(init, cfg)
    attrs = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if f.name in ("enc_vocab_size", "dec_vocab_size", "enc_embedding_size",
                           "dec_embedding_size", "max_seq_len_src", "max_seq_len_tgt",
                           "num_heads", "dim_model", "dim_feedforward", "enc_layers",
                           "dec_layers", "act", "transformer_type", "acous_dim",
                           "acous_hidden_size", "mode")}
    code = (f"import sys, torch, numpy as np, dill; sys.path.insert(0, {str(ref_root)!r}); "
            "from models.Seq2seq import Seq2seq; "
            f"named = dict(np.load({str(tmp_path / 'named.npz')!r})); "
            f"m = Seq2seq(named, {attrs!r}); m.dec_embedder = 0; "
            f"torch.save(m, {str(tmp_path / 'ckpt' / 'model.pt')!r})")
    np.savez(tmp_path / "named.npz", **named)
    (tmp_path / "ckpt").mkdir()
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    for name, vocab in (("input_vocab.pt", [f"w{i}" for i in range(20)]),
                        ("output_vocab.pt", [f"c{i}" for i in range(18)])):
        with open(tmp_path / "ckpt" / name, "wb") as f:
            dill.dump(vocab, f)
    dyn = np.linspace(-1, 1, cfg.dim_model).astype(np.float32)
    np.save(tmp_path / "dyn.npy", dyn)
    script = REPO / "stjep_tpu_torch" / "scripts" / "convert_torch_checkpoint.py"
    args = [sys.executable, str(script), "--torch_ckpt", str(tmp_path / "ckpt"),
            "--out", str(tmp_path / "out"), "--emb_dyn_ave", str(tmp_path / "dyn.npy")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(args, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and "--reference" in r.stderr  # the package is missing
    r = subprocess.run(args + ["--reference", str(ref_root)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    got_cfg, params, ckpt = _load_model(str(tmp_path / "out"), device="cpu")
    assert got_cfg.act and got_cfg.transformer_type == "universal"
    assert ckpt.input_vocab[3] == "w3" and ckpt.output_vocab[17] == "c17"
    init["emb_dyn_ave"] = dyn
    _same_tree(params, init)
