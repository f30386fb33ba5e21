"""Token ids and the model configuration of the port.

A copy of the data in stjep_tpu/config.py (ref: utils/config.py:1-7,
models/Seq2seq.py:30-61), kept here so that the port and its GPU entry
points load nothing of the JAX package. tests/test_torch_bridge.py pins the
two copies equal: same ids, same fields and defaults, same derived
properties. Either class may be passed to the port's functions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PAD = 0
UNK = 1
BOS = 2
EOS = 3
SPC = 4


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
