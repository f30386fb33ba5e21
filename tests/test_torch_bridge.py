"""Port (stjep_tpu_torch) vs JAX: weight bridge, init layout, masks, and
the package boundary (the port never imports JAX)."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stjep_tpu.config import ModelConfig
from stjep_tpu.models.seq2seq import init_seq2seq as jax_init
from stjep_tpu.ops import masks as jmasks
from stjep_tpu_torch import bridge
from stjep_tpu_torch.models.seq2seq import init_seq2seq
from stjep_tpu_torch.ops import masks

CFG = ModelConfig(
    enc_vocab_size=50, dec_vocab_size=40, enc_embedding_size=16,
    dec_embedding_size=128, acous_dim=8, acous_hidden_size=64, dim_model=128,
    dim_feedforward=256, num_heads=4, enc_layers=2, dec_layers=2,
    num_unilstm_dec=3, spec_aug=False, dropout=0.0, max_seq_len_src=12,
    max_seq_len_tgt=16, mode="ASR_ST")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), CFG))


def test_bridge_round_trips_bytes(jax_params):
    back = bridge.params_to_numpy(bridge.params_from_numpy(jax_params))
    a, b = _flat(jax_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("share", [False, True])
def test_init_matches_jax_layout(share):
    cfg = ModelConfig(**{**CFG.__dict__, "share_embedder": share,
                         "dec_vocab_size": CFG.enc_vocab_size if share else 40})
    ref = _flat(jax.tree_util.tree_map(np.asarray,
                                       jax_init(jax.random.PRNGKey(0), cfg)))
    mine = _flat(init_seq2seq(cfg, torch.Generator().manual_seed(0)))
    assert ref.keys() == mine.keys()
    for k in ref:
        assert tuple(ref[k].shape) == tuple(mine[k].shape), k
        assert mine[k].dtype == torch.float32, k
    table = mine["/las/decoder/embedder"]
    assert torch.all(table[0] == 0)  # PAD row


def test_masks_equal():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 5, size=(3, 9)).astype(np.int32)
    lens = np.array([0, 4, 9], np.int32)
    np.testing.assert_array_equal(
        masks.pad_mask(torch.from_numpy(ids)).numpy(),
        np.asarray(jmasks.pad_mask(ids)))
    np.testing.assert_array_equal(masks.subsequent_mask(7).numpy(),
                                  np.asarray(jmasks.subsequent_mask(7)))
    np.testing.assert_array_equal(
        masks.length_mask(torch.from_numpy(lens), 9).numpy(),
        np.asarray(jmasks.length_mask(lens, 9)))
    for x in (0, 7, 8, 9, 16, 1503):
        assert masks.round_up8(x) == jmasks.round_up8(x)
    np.testing.assert_array_equal(
        masks.round_up8(torch.from_numpy(lens)).numpy(),
        np.asarray(jmasks.round_up8(lens)))


@pytest.mark.parametrize("d_model", [7, 8, 128])
def test_position_signal_equal(d_model):
    np.testing.assert_array_equal(masks.position_signal(50, d_model).numpy(),
                                  np.asarray(jmasks.position_signal(50, d_model)))


def test_port_imports_no_jax():
    code = ("import sys; import stjep_tpu_torch.infer.forward, "
            "stjep_tpu_torch.bridge, stjep_tpu_torch.kernels, "
            "stjep_tpu_torch.train.trainer, stjep_tpu_torch.parallel.spmd, "
            "stjep_tpu_torch.ops.decode_flash_tp, stjep_tpu_torch.scripts.tp_bounds; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stjep_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]"


def test_config_copy_matches_jax_package():
    import dataclasses

    from stjep_tpu import config as jcfg
    from stjep_tpu_torch import config as tcfg

    for name in ("PAD", "UNK", "BOS", "EOS", "SPC"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(tcfg.ModelConfig) == fields(jcfg.ModelConfig)
    for kw in ({}, {"mode": "ST", "load_mode": "ASR"}, {"mode": "MT"},
               {"dec_embedding_size": 512}, {"dec_emb_proj": True}):
        a, b = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
        for prop in ("comb_mode", "has_las", "has_transformer", "d_k",
                     "dec_emb_proj_flag"):
            assert getattr(a, prop) == getattr(b, prop), (kw, prop)
