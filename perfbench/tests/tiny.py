"""A tiny copy of the benchmark for the CPU tests: the stjep configurations
at small widths, the traffic mixes at small shapes, and limits that the
plain routes meet by rounding alone. `install(monkeypatch, tmp_path)`
points the harness's registry at them and returns the bench dict."""

from __future__ import annotations

import json

from perfbench import registry

MODEL = dict(enc_vocab_size=50, dec_vocab_size=30, enc_embedding_size=8, dec_embedding_size=32,
             dim_model=32, dim_feedforward=64, num_heads=4, enc_layers=2, dec_layers=2,
             acous_dim=8, acous_hidden_size=16, num_unilstm_dec=3, num_pyramid_layers=4,
             acous_att_mode="bilinear", max_seq_len_src=12, max_seq_len_tgt=15,
             transformer_type="standard", share_embedder=False, embedding_dropout=0.0)

TRAFFIC = {
    "st_beam_b64": {"entry": "st_beam", "mode": "ST", "batch": 4, "pool": 2, "frames": [40, 96],
                    "beam": 3, "penalty": 1.0, "max_seq_len": 15, "check_batches": 2,
                    "trace_units": 1},
    "train_asr_st_b32": {"entry": "train_step", "mode": "ASR_ST", "batch": 3, "pool": 4,
                         "frames": [48, 96], "pad_frames": 104, "src_len": [12, 12],
                         "pad_src": 12, "tgt_len": [15, 15], "pad_tgt": 15, "dropout": 0.2,
                         "spec_aug": True, "lr": 1e-3, "max_grad_norm": 1.0, "check_steps": 3,
                         "trace_units": 1},
    "train_mt_b64": {"entry": "train_step", "mode": "MT", "batch": 4, "pool": 4,
                     "src_len": [4, 11], "pad_src": 12, "tgt_len": [5, 14], "pad_tgt": 15,
                     "dropout": 0.2, "spec_aug": True, "lr": 1e-3, "max_grad_norm": 1.0,
                     "check_steps": 3, "trace_units": 1},
}

# the plain routes on the CPU against the plain reference: rounding only
LIMITS = {"st_beam": {"asr_gap": 1e-5, "dyn_emb_err": 1e-4, "st_select_gap": 1e-4,
                      "st_score_err": 1e-3},
          "train_step": {"loss_err": 1e-4, "grad_err": 1e-3, "change_err": 1e-2}}


def install(monkeypatch, tmp_path):
    bench = registry.benchmark()
    for c in bench["configs"]:
        full = registry.config(bench, c["name"])
        model = dict(MODEL, transformer_type=full["model"]["transformer_type"])
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps({**full, "model": model}))
        c["file"] = str(path)
    monkeypatch.setattr(registry, "traffic", lambda name, here=None: dict(TRAFFIC[name]))
    monkeypatch.setattr(registry, "limits",
                        lambda cell, here=None: {"limits": dict(
                            LIMITS[TRAFFIC[registry.cell(bench, cell)["traffic"]]["entry"]])})
    return bench
