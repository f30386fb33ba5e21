"""The one generator of the benchmark's inputs: a traffic file's parameters
and the seed give the host pool of batches.

Every seed gets the same work: each batch holds the same multiset of
lengths (evenly spaced over the file's range, both ends included), in an
order the seed draws, and the seed draws the features and ids. A range
[lo, hi] with lo == hi gives every row that length.

Keys a traffic file may hold:
- entry: the runner under perfbench/entries/ ("st_beam", "train_step");
- mode: the program's mode (ST for decode; ASR_ST or MT for training);
- batch: rows a batch; pool: distinct batches the window cycles through;
- frames [lo, hi]: acoustic frames a row; pad_frames: the batch's frame
  axis, else round_up8 (x + 8 - x % 8) of the longest row;
- src_len, tgt_len [lo, hi]: ids a row, BOS first and EOS last when
  shorter than its pad, PAD after; pad_src, pad_tgt: their axes;
- beam, penalty, max_seq_len: the decode's arguments;
- dropout, spec_aug, lr, max_grad_norm: the training step's settings;
- check_batches / check_steps: how many batches the comparison samples,
  or steps it follows; trace_units: batches or steps under the profiler.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PAD, BOS, EOS, FIRST_ID = 0, 2, 3, 5


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths evenly spaced over [lo, hi], both ends included."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def _ids(rng, lens, pad: int, vocab: int) -> np.ndarray:
    out = np.full((len(lens), pad), PAD, dtype=np.int64)
    for r, n in enumerate(lens):
        out[r, :n] = rng.integers(FIRST_ID, vocab, size=n)
        out[r, 0] = BOS
        if n < pad:
            out[r, n - 1] = EOS
    return out


def make_pool(traffic: Dict, model: Dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """`traffic["pool"]` host batches for `seed`, each a dict of numpy
    arrays: acous_feat [B, T, C] float32 (zero past a row's frames) and
    acouslen [B] where the traffic has frames; srcid, tgtid where it has
    ids."""
    rng = np.random.default_rng(int(seed))
    B = traffic["batch"]
    pool = []
    for _ in range(traffic["pool"]):
        item: Dict[str, np.ndarray] = {}
        if "frames" in traffic:
            lens = rng.permutation(spread(*traffic["frames"], B))
            hi = int(lens.max())
            T = traffic.get("pad_frames", hi + 8 - hi % 8)
            feats = rng.standard_normal((B, T, model["acous_dim"]), dtype=np.float32)
            feats[np.arange(T)[None, :] >= lens[:, None]] = 0.0
            item["acous_feat"], item["acouslen"] = feats, lens
        if "src_len" in traffic:
            lens = rng.permutation(spread(*traffic["src_len"], B))
            item["srcid"] = _ids(rng, lens, traffic["pad_src"], model["enc_vocab_size"])
        if "tgt_len" in traffic:
            lens = rng.permutation(spread(*traffic["tgt_len"], B))
            item["tgtid"] = _ids(rng, lens, traffic["pad_tgt"], model["dec_vocab_size"])
        pool.append(item)
    return pool
