"""N-gram LM shallow fusion for the LAS greedy decode, on the host (a copy
of stjep_tpu/infer/lm_fusion.py, numpy only; tests/test_torch_lm_fusion.py
pins the two equal).

Rebuild of ref: models/Dec.py:236-317 (add_lm, mode 's-4g_<alpha>'): per
step, re-rank only the TOP-10 candidates by combining the network posterior
with an external n-gram LM (an NLTK-style object exposing
.logscore(word, context) over stringified token ids), via
    comb[j] = log(exp(logp[j]) + alpha * exp(log_softmax(lm_scores)[j])).

The LM object lives on the host, so the LAS step loop hands each step's
log-probs to this function on a host copy (models/las_decoder.py, the
port's counterpart of JAX's pure_callback); context is the last min(3,
step) emitted ids, or ['2'] (BOS) at step 0, exactly as the reference
builds it. infer/lm_table.py is the on-device alternative.
"""

from __future__ import annotations

import math

import numpy as np

from stjep_tpu_torch.config import BOS

TOP_N = 10  # ref: Dec.py:287


def make_ngram_fuser(lm_model, lm_mode: str):
    """Returns a host callback (logp [B,V], ctx [B,3], step) -> [B,V], or
    None for lm_mode 'null'."""
    if lm_mode == "null" or lm_model is None:
        return None
    mode = lm_mode.split("_")[0]
    alpha = float(lm_mode.split("_")[-1])
    if mode != "s-4g":
        raise NotImplementedError(f"lm_mode {lm_mode} not implemented")

    def fuse(logp, ctx, step):
        logp = np.asarray(logp)
        ctx = np.asarray(ctx)
        step = int(step)
        out = logp.copy()
        for b in range(logp.shape[0]):
            if step == 0:
                context = [str(BOS)]
            else:
                n_ctx = min(3, step)
                context = [str(int(t)) for t in ctx[b, 3 - n_ctx:]]
            row = logp[b]
            top = np.argsort(row)[::-1][:TOP_N]
            raw = []
            for j in top:
                score = lm_model.logscore(str(int(j)), context)
                if math.isinf(score):
                    score = -1e10  # ref: Dec.py:293-295
                raw.append(score)
            raw = np.asarray(raw, dtype=np.float64)
            lsm = raw - raw.max()
            lsm = lsm - np.log(np.exp(lsm).sum())
            for k, j in enumerate(top):
                out[b, j] = np.log(np.exp(row[j]) + alpha * np.exp(lsm[k]))
        return out.astype(logp.dtype)

    return fuse
