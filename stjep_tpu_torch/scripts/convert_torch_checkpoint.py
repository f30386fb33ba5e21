#!/usr/bin/env python3
"""Convert a reference PyTorch checkpoint directory into a checkpoint of
the port (stjep_tpu_torch), with the flags of scripts/convert_torch_checkpoint.py.

    python3 stjep_tpu_torch/scripts/convert_torch_checkpoint.py \
        --torch_ckpt /path/to/checkpoints/<timestamp> --out /path/to/out_ckpt \
        [--reference /path/to/reference] [--emb_dyn_ave dyn_emb_ave.npy]

The reference pickles whole nn.Module objects (ref: modules/checkpoint.py:76)
and its vocabularies with dill, so unpickling needs the reference package
importable (`--reference` puts its root on sys.path) and the `dill`
package; without either the script stops with an error that says which.
The output is the port's checkpoint (flax msgpack params, meta.json with
model_config, the vocab JSONs; train/checkpoint.py), which the port's
translate CLI (`--load`) and train CLI (`--load`) read, e.g. an ACT
universal transformer for decoding and dev eval.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import types
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stjep_tpu_torch.config import ModelConfig  # noqa: E402
from stjep_tpu_torch.train.checkpoint import Checkpoint  # noqa: E402
from stjep_tpu_torch.train.convert import convert_torch_model  # noqa: E402


def model_config(model) -> ModelConfig:
    """The ModelConfig of an unpickled reference Seq2seq, from its
    attributes; a missing one takes the reference's check_var default
    (ref: models/Seq2seq.py:906-914)."""
    def attr(name, default):
        return getattr(model, name, default)

    las = getattr(model, "las", None)
    return ModelConfig(
        enc_vocab_size=attr("enc_vocab_size", 32),
        dec_vocab_size=attr("dec_vocab_size", 32),
        share_embedder=model.enc_embedder is model.dec_embedder,
        enc_embedding_size=attr("enc_embedding_size", 200),
        dec_embedding_size=attr("dec_embedding_size", 200),
        max_seq_len_src=attr("max_seq_len_src", 32),
        max_seq_len_tgt=attr("max_seq_len_tgt", 300),
        num_heads=attr("num_heads", 8), dim_model=attr("dim_model", 512),
        dim_feedforward=attr("dim_feedforward", 1024),
        enc_layers=attr("enc_layers", 6), dec_layers=attr("dec_layers", 6),
        act=bool(attr("act", False)),
        transformer_type=attr("transformer_type", "standard"),
        acous_dim=attr("acous_dim", 40),
        acous_hidden_size=attr("acous_hidden_size", 256),
        num_unilstm_dec=las.decoder.num_unilstm_dec if las is not None else 3,
        mode=attr("mode", "ASR"), load_mode=attr("load_mode", None))


def write_checkpoint(model, input_vocab: Sequence[str], output_vocab: Sequence[str],
                     out: str, emb_dyn_ave: Optional[np.ndarray] = None) -> str:
    """Convert `model` (a reference Seq2seq, live or unpickled) and write it
    with its vocabularies as the port's checkpoint at `out`; emb_dyn_ave
    (the dyn_emb_ave.npy artifact) replaces the model's buffer. Returns
    the path written."""
    cfg = model_config(model)
    params = convert_torch_model(model, cfg)
    if emb_dyn_ave is not None:
        params["emb_dyn_ave"] = torch.from_numpy(
            np.asarray(emb_dyn_ave, np.float32).reshape(-1).copy())
    ck = Checkpoint(params=params, epoch=0, step=0, input_vocab=list(input_vocab),
                    output_vocab=list(output_vocab), model_config=dataclasses.asdict(cfg))
    return ck.save_customise(out)


def _unpickler(reference: Optional[str]):
    """dill, with the reference package importable: its modules import
    bpemb, which unpickling never calls, so a stub stands in for it."""
    if reference is not None:
        sys.path.insert(0, reference)
    sys.modules.setdefault("bpemb", types.ModuleType("bpemb"))
    sys.modules["bpemb"].BPEmb = object
    try:
        import dill
    except ImportError as e:
        raise SystemExit(
            "convert_torch_checkpoint: unpickling a reference checkpoint needs the "
            "dill package, which is not installed") from e
    return dill


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--reference", default=None,
                    help="root of the reference package (put on sys.path to unpickle)")
    ap.add_argument("--emb_dyn_ave", default=None)
    args = ap.parse_args(argv)
    dill = _unpickler(args.reference)
    try:
        model = torch.load(os.path.join(args.torch_ckpt, "model.pt"),
                           map_location=lambda storage, loc: storage, weights_only=False)
    except ModuleNotFoundError as e:
        raise SystemExit(
            f"convert_torch_checkpoint: unpickling model.pt needs the reference "
            f"package ({e}); pass its root as --reference") from e
    vocabs = []
    for name in ("input_vocab.pt", "output_vocab.pt"):
        with open(os.path.join(args.torch_ckpt, name), "rb") as f:
            vocabs.append(dill.load(f))
    dyn = np.load(args.emb_dyn_ave) if args.emb_dyn_ave else None
    path = write_checkpoint(model, vocabs[0], vocabs[1], args.out, dyn)
    print("converted ->", path)
    return path


if __name__ == "__main__":
    main()
