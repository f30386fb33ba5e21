"""Token ids, config plumbing and the model configuration of the port.

A copy of stjep_tpu/config.py (ref: utils/config.py:1-7,
models/Seq2seq.py:30-61, utils/misc.py:174-231), kept here so that the port
and its GPU entry points load nothing of the JAX package.
tests/test_torch_bridge.py and tests/test_torch_data.py pin the two copies
equal: same ids and token strings, same fields and defaults, same derived
properties, and the same config files read and written. Either class may
be passed to the port's functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"
BOS_TOKEN = "<s>"
EOS_TOKEN = "</s>"
SPC_TOKEN = "<spc>"

PAD = 0
UNK = 1
BOS = 2
EOS = 3
SPC = 4


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Normalise string booleans/none ('true'/'false'/'none' case-insensitive)
    to Python values (ref: utils/misc.py:220-231)."""
    for key, val in config.items():
        if isinstance(val, str):
            low = val.lower()
            if low == "true":
                config[key] = True
            elif low == "false":
                config[key] = False
            elif low == "none":
                config[key] = None
    return config


def save_config(config: Dict[str, Any], save_path: str) -> None:
    """Write a `key:value` config snapshot (ref: utils/misc.py:212-217)."""
    with open(save_path, "w") as f:
        for key, val in config.items():
            f.write("{}:{}\n".format(key, val))


def _isfloat(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_config(path: str) -> Dict[str, Any]:
    """Read a `key=value` config file (ref: utils/misc.py:181-202)."""
    config: Dict[str, Any] = {}
    with open(path, "r") as f:
        for line in f:
            x = line.strip().split("=")
            key = x[0]
            raw = x[1]
            if raw.isdigit():
                val: Any = int(raw)
            elif _isfloat(raw):
                val = float(raw)
            elif raw.lower() in ("true", "false"):
                val = raw.lower() == "true"
            else:
                val = raw
            config[key] = val
    return config


@dataclasses.dataclass
class ModelConfig:
    """Hyperparameters of the composite Seq2seq (field names mirror the
    reference ctor args and LAS's fixed hyperparameters)."""

    enc_vocab_size: int = 32
    dec_vocab_size: int = 32
    share_embedder: bool = False
    enc_embedding_size: int = 200
    dec_embedding_size: int = 200
    max_seq_len_src: int = 32
    max_seq_len_tgt: int = 300
    num_heads: int = 8
    dim_model: int = 512
    dim_feedforward: int = 1024
    enc_layers: int = 6
    dec_layers: int = 6
    embedding_dropout: float = 0.0
    dropout: float = 0.2
    act: bool = False
    act_max_hop: Optional[int] = None
    transformer_type: str = "standard"  # standard | universal
    dec_emb_proj: bool = False
    acous_dim: int = 40
    acous_hidden_size: int = 256
    acous_att_mode: str = "bilinear"
    num_unilstm_dec: int = 3
    num_pyramid_layers: int = 4
    spec_aug: bool = True
    mode: str = "ASR"
    load_mode: Optional[str] = None
    attn_dropout: float = 0.1
    remat: bool = False

    @property
    def comb_mode(self) -> str:
        lm = self.load_mode if self.load_mode is not None else "null"
        return "-".join([self.mode, str(lm)])

    @property
    def has_las(self) -> bool:
        return ("ASR" in self.comb_mode) or ("ST" in self.comb_mode)

    @property
    def has_transformer(self) -> bool:
        return ("ST" in self.comb_mode) or ("MT" in self.comb_mode)

    @property
    def d_k(self) -> int:
        return self.dim_model // self.num_heads

    @property
    def dec_emb_proj_flag(self) -> bool:
        return (self.dec_embedding_size != self.dim_model) or self.dec_emb_proj
