"""Host-side utilities: detokenisation, corpus accumulation, seeds, memory
(port of stjep_tpu/utils/misc.py; tests/test_torch_data.py pins the copies
equal).

`root_key`, `flash_kernels_disabled` and `enable_compilation_cache` have no
counterpart: the port draws from host `torch.Generator`s, has no switch
that routes a kernel to its plain version, and builds its kernels at first
use (kernels.py) instead of caching XLA programs.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from stjep_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SPC_TOKEN

# the config helpers under their reference names
from stjep_tpu_torch.config import read_config, save_config, validate_config  # noqa: F401


def set_global_seeds(i: int):
    """Seed the host RNGs (ref: utils/misc.py:162-171): numpy, Python and
    torch's default generator. Training draws from explicit generators
    seeded from this seed."""
    np.random.seed(i)
    random.seed(i)
    torch.manual_seed(i)


def get_memory_alloc(device=None) -> Tuple[float, float, float]:
    """(kb, mb, gb) of the card's peak allocated memory
    (torch.cuda.max_memory_allocated), or all zeros without a card. The
    JAX package reports the host process's RSS, as the reference's
    helper does (ref: utils/misc.py:136-146); on the card the number that
    limits a run is the device's."""
    mem_byte = (torch.cuda.max_memory_allocated(device)
                if torch.cuda.is_available() else 0)
    mem_kb = float(mem_byte) / 1024.0
    return mem_kb, mem_kb / 1024.0, mem_kb / 1024.0 / 1024.0


def _convert_to_words_batchfirst(seqlist, id2word) -> List[List[str]]:
    """[num_batch x seq_len] ids -> words (ref: utils/misc.py:344-365)."""
    arr = np.asarray(seqlist)
    return [[id2word.get(int(tok), PAD_TOKEN) if isinstance(id2word, dict)
             else id2word[int(tok)] for tok in row] for row in arr]


def detok_words(words: Sequence[str], use_type: str = "word",
                seqrev: bool = False) -> str:
    """Join tokens into an output line: skip <pad>, map <spc> to space, stop
    at </s> (ref: translate.py:174-194, utils/misc.py:42-62)."""
    out = []
    for word in words:
        if word == PAD_TOKEN:
            continue
        elif word == SPC_TOKEN:
            out.append(" ")
        elif word == EOS_TOKEN:
            break
        else:
            out.append(word)
    if not out:
        return ""
    if seqrev:
        out = out[::-1]
    return " ".join(out) if use_type == "word" else "".join(out)


def add2corpus(hyp_ids, ref_ids, id2word, hyp_corpus, ref_corpus,
               use_type: str = "char"):
    """Accumulate hyp/ref token lists for corpus BLEU
    (ref: utils/misc.py:35-91). ref_ids' leading BOS column is dropped."""
    hyp_toks = _convert_to_words_batchfirst(hyp_ids, id2word)
    ref_toks = _convert_to_words_batchfirst(np.asarray(ref_ids)[:, 1:], id2word)
    for i in range(len(hyp_toks)):
        hyp_line = detok_words(hyp_toks[i], use_type=use_type)
        ref_line = detok_words(ref_toks[i], use_type=use_type)
        hyp_corpus.append(hyp_line.split())
        ref_corpus.append([ref_line.split()])
    return hyp_corpus, ref_corpus


def print_config(config: Dict):
    print("\n-------- Config --------")
    for key, val in config.items():
        print("{}:{}".format(key, val))
