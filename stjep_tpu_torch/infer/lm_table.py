"""On-device n-gram LM shallow fusion via a hashed probe table in device
memory (port of stjep_tpu/infer/lm_table.py).

The host fuser (infer/lm_fusion.py) calls a host Python object per
candidate per decode step, so every LAS step waits on a round trip to the
host. This module keeps the step on the card: the n-gram model's explicit
entries are packed once into flat arrays (an open-addressed hash table),
uploaded once, and each decode step scores its TOP_N candidates with
gathers. The JAX package writes the probe as plain XLA gathers with no
Pallas kernel, so stock torch ops are its port.

Table layout (numpy -> device):
    h2   [S] int64    second hash of the stored key, a uint32 value (slot
                      occupancy + verify; 0 = empty)
    val  [S] float32  log-probability of the ngram as the builder passes it
    bow  [S] float32  backoff weight of a *context* entry (0.0 if none)

Keys are (token..., ) int tuples; an ngram entry's key is (ctx..., word),
a backoff entry's key is (ctx...,). Two independent 32-bit multiplicative
hashes give an effective 64-bit identity check; the builder verifies that
stored keys do not collide and that linear probing terminates within
MAX_PROBES for every stored key. `from_ngrams` is the JAX builder's numpy
code, so both packages place every key in the same slot.

Torch has no general uint32 arithmetic on the card, so `_hash_torch`
computes the hash in int64 on values below 2^32, splitting each multiply
into 16-bit halves of the multiplier so that no product overflows, and
masks to 32 bits: bit for bit `_hash_np`.

Scoring semantics:
- backoff=True: standard ARPA/Katz recursion
      score(w | c) = logp(c+w)                      if c+w stored
                   = bow(c) + score(w | c[1:])      otherwise
  with bow() = 0 for absent contexts and a floor of MISS_SCORE when no
  level matches (mirrors the reference's -inf -> -1e10 clamp, Dec.py:293-295).
- backoff=False (strict): probe only the exact-order ngram; a miss scores
  MISS_SCORE, as an NLTK MLE model's -inf is clamped on the host path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from stjep_tpu_torch.config import BOS

TOP_N = 10  # ref: Dec.py:287
MISS_SCORE = -1e10  # ref: Dec.py:293-295 (-inf clamp)
MAX_PROBES = 16
_EMPTY = np.uint32(0)

_MULT1 = np.uint32(0x9E3779B1)
_MULT2 = np.uint32(0x85EBCA77)
_SEED1 = np.uint32(0x811C9DC5)
_SEED2 = np.uint32(0xC2B2AE3D)
_M32 = 0xFFFFFFFF


def _hash_np(tokens: np.ndarray, mult: np.uint32, seed: np.uint32) -> np.ndarray:
    """Vector hash of [..., K] int token arrays -> [...] uint32 (host)."""
    h = np.full(tokens.shape[:-1], seed, np.uint32)
    for k in range(tokens.shape[-1]):
        t = tokens[..., k].astype(np.uint32)
        h = (h ^ (t + np.uint32(1))) * mult
        h = h ^ (h >> np.uint32(15))
    return h


def _mul32(h: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(h * mult) mod 2^32 for int64 h in [0, 2^32), given the multiplier's
    16-bit halves lo and hi (broadcasting against h): the low half gives
    products below 2^48, and of the high half's product only its low 16
    bits reach the low 32 bits of the result."""
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _hash_torch(tokens: torch.Tensor, mult, seed,
                length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """_hash_np on a tensor, bit for bit: tokens [..., K] int -> int64
    holding the uint32 hash. mult and seed are ints or int64 tensors of
    one shape [n...] (several hashes at once): the result is [n..., ...].
    With `length` (an int tensor broadcasting against the result) each
    key's hash is that of its last `length` tokens."""
    dev = tokens.device
    lead = tokens.shape[:-1]
    mult = torch.as_tensor(mult, dtype=torch.int64, device=dev)
    shape = mult.shape + (1,) * len(lead)
    mult = mult.reshape(shape)
    lo, hi = mult & 0xFFFF, mult >> 16
    h = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(shape) \
        + torch.zeros(lead, dtype=torch.int64, device=dev)
    t1 = ((tokens.long() & _M32) + 1) & _M32  # each token as uint32, plus 1
    K = tokens.shape[-1]
    for k, t in enumerate(t1.unbind(-1)):
        g = _mul32(h ^ t, lo, hi)
        g = g ^ (g >> 15)
        h = g if length is None else torch.where(length > K - 1 - k, g, h)
    return h


def _hash_tuple(key: Tuple[int, ...], mult, seed) -> np.uint32:
    arr = np.asarray(key, np.int64).reshape(1, -1)
    return _hash_np(arr, mult, seed)[0]


class NGramTable:
    """Host-built, device-queried hashed n-gram table."""

    def __init__(self, h2, val, bow, size: int, order: int, backoff: bool):
        self.h2 = h2  # int64 [S]; 0 = empty slot
        self.val = val  # float32 [S]
        self.bow = bow  # float32 [S]
        self.size = size
        self.order = order
        self.backoff = backoff
        self.on_device = True
        # the probe offsets, the two hashes' multipliers and seeds, and a
        # score's key lengths by context width, on the table's device
        dev = h2.device
        self._probes = torch.arange(MAX_PROBES, device=dev)
        self._mults = torch.tensor([int(_MULT1), int(_MULT2)], device=dev)
        self._seeds = torch.tensor([int(_SEED1), int(_SEED2)], device=dev)
        self._lengths: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_ngrams(
        cls,
        entries: Dict[Tuple[int, ...], float],
        backoffs: Optional[Dict[Tuple[int, ...], float]] = None,
        order: int = 4,
        device="cuda",
    ) -> "NGramTable":
        """Pack explicit ngram logprobs (+ optional context backoff weights)
        into the flat table and upload it to `device` (the card unless the
        caller asks for the CPU). Keys are int tuples (ctx..., word) for
        entries and (ctx...,) for backoffs; a tuple may appear in both (its
        slot then carries both val and bow, as in ARPA files)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible for the n-gram table "
                               "(from_ngrams(..., device='cpu') builds it on the host)")
        backoffs = backoffs or {}
        keys = sorted(set(entries) | set(backoffs))
        n = len(keys)
        size = 8
        while size < 4 * max(n, 1):
            size *= 2

        for attempt in range(3):
            h2a = np.zeros(size, np.uint32)
            vala = np.full(size, MISS_SCORE, np.float32)
            bowa = np.zeros(size, np.float32)
            used = np.zeros(size, bool)
            keyat: Dict[int, Tuple[int, ...]] = {}
            ok = True
            for key in keys:
                hh1 = int(_hash_tuple(key, _MULT1, _SEED1))
                hh2 = int(_hash_tuple(key, _MULT2, _SEED2))
                if hh2 == int(_EMPTY):
                    hh2 = 1  # 0 marks empty slots
                placed = False
                for p in range(MAX_PROBES):
                    s = (hh1 + p) % size
                    if not used[s]:
                        used[s] = True
                        h2a[s] = hh2
                        keyat[s] = key
                        placed = True
                        break
                    if h2a[s] == hh2:
                        # same 64-bit identity from a different key = a real
                        # collision the device probe could not distinguish
                        if keyat[s] != key:
                            raise ValueError(
                                f"ngram hash collision: {keyat[s]} vs {key}"
                            )
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
                if key in entries:
                    vala[s] = np.float32(entries[key])
                if key in backoffs:
                    bowa[s] = np.float32(backoffs[key])
            if ok:
                break
            size *= 2  # probe chain overflow: grow and retry
        else:
            raise ValueError("could not place all ngrams within MAX_PROBES")

        return cls(
            torch.from_numpy(h2a.astype(np.int64)).to(device),
            torch.from_numpy(vala).to(device), torch.from_numpy(bowa).to(device),
            size=size, order=order, backoff=backoffs is not None and len(backoffs) > 0,
        )

    # ------------------------------------------------------------- queries

    def _probe(self, tokens: torch.Tensor, length: Optional[torch.Tensor] = None):
        """tokens [..., K] int -> (found [...], val [...], bow [...]) of each
        key: the last `length` tokens (all K where None). A key's probe
        chain, MAX_PROBES slots, is read in one gather; its first slot that
        holds the key or is empty decides."""
        hh1, hh2 = _hash_torch(tokens, self._mults, self._seeds, length)
        hh2 = hh2.clamp_min(1)  # as the builder stores it: 0 marks an empty slot
        s = (hh1[..., None] + self._probes) & (self.size - 1)
        slot_h2 = self.h2[s]
        hit = slot_h2 == hh2[..., None]
        stop = hit | (slot_h2 == 0)
        first = stop & (stop.cumsum(-1) == 1)
        found = (hit & first).any(-1)
        slot = (s * first).sum(-1)
        val = torch.where(found, self.val[slot], torch.full_like(found, MISS_SCORE,
                                                                 dtype=torch.float32))
        bow = torch.where(found, self.bow[slot], torch.zeros_like(found, dtype=torch.float32))
        return found, val, bow

    def score(self, ctx_tokens: torch.Tensor, n_ctx: int, word: torch.Tensor) -> torch.Tensor:
        """logscore(word | last-n_ctx tokens of ctx_tokens).

        ctx_tokens [..., C] int (C = order-1 slots, oldest first), n_ctx an
        int in [0, C], word [...] int. Returns [...] float32.
        """
        C = ctx_tokens.shape[-1]
        word = word.long()
        ctx_tokens = ctx_tokens.long()

        # For each context length k (0..C): the ngram (suffix_k + word) and
        # the context backoff (suffix_k). All 2C + 1 keys in one probe: the
        # last k + 1 tokens of [ctx, word] (k = 0..C), then the last k of
        # [0, ctx] (k = 1..C).
        full = torch.cat([ctx_tokens, word[..., None]], dim=-1)
        ctxp = torch.cat([torch.zeros_like(word)[..., None], ctx_tokens], dim=-1)
        keys = torch.stack([full] * (C + 1) + [ctxp] * C)
        if C not in self._lengths:
            self._lengths[C] = torch.tensor(list(range(1, C + 2)) + list(range(1, C + 1)),
                                            device=self.h2.device)
        found, val, bow = self._probe(keys, self._lengths[C].view(-1, *[1] * word.dim()))

        miss = torch.full(word.shape, MISS_SCORE, dtype=torch.float32, device=word.device)
        if not self.backoff:
            # strict: only the exact-order probe counts
            return torch.where(found[n_ctx], val[n_ctx], miss)

        # ARPA backoff: the highest found order up to n_ctx wins; accumulate
        # the bow of every higher (missed) order along the way (a settled
        # key's acc is read no more, so it may go on adding)
        found, val, bow = found.unbind(0), val.unbind(0), bow.unbind(0)
        score = miss
        acc = torch.zeros_like(miss)
        settled = torch.zeros(word.shape, dtype=torch.bool, device=word.device)
        for k in range(n_ctx, -1, -1):
            take = found[k] & ~settled
            score = torch.where(take, acc + val[k], score)
            if k:
                settled = settled | take
                acc = acc + bow[C + k]
        return score


def make_table_fuser(table: NGramTable, lm_mode: str):
    """On-device equivalent of infer/lm_fusion.make_ngram_fuser: returns a
    (logp [B,V], ctx [B,3], step int) -> [B,V] function on the table's
    device with fn.on_device = True, or None for 'null'. The top TOP_N
    candidates come in jax.lax.top_k's order, the lowest id first among
    ties: the head of a stable descending sort, one operation where
    `topk_lowest_index` takes four a candidate."""
    if lm_mode == "null" or table is None:
        return None
    mode = lm_mode.split("_")[0]
    alpha = float(lm_mode.split("_")[-1])
    if mode != "s-4g":
        raise NotImplementedError(f"lm_mode {lm_mode} not implemented")

    def fuse(logp, ctx, step):
        step = int(step)
        top_v, top_i = (a[:, :TOP_N] for a in torch.sort(logp, dim=-1, descending=True,
                                                          stable=True))  # [B, N]
        # context: last min(3, step) emitted ids, or [BOS] at step 0 (the
        # reference's context build, ref: Dec.py:283-285 / infer/lm_fusion.py);
        # step 0 = length-1 context with BOS in the newest slot
        ctx_eff = ctx.long()
        if step == 0:
            ctx_eff = ctx_eff.clone()
            ctx_eff[:, 2] = BOS
        n_eff = 1 if step == 0 else min(step, 3)
        raw = table.score(ctx_eff[:, None, :].expand(-1, TOP_N, -1), n_eff, top_i)  # [B, N]
        lsm = torch.log_softmax(raw, dim=-1)
        comb = torch.log(torch.exp(top_v) + alpha * torch.exp(lsm)).to(logp.dtype)
        return logp.scatter(1, top_i, comb)

    fuse.on_device = True
    return fuse
