"""Feature staging compression: int8 quantization and the device-resident
corpus cache (port of stjep_tpu/data/device_cache.py).

- int8 staging (`quantize_batch`, numpy, a copy of the JAX function):
  per-utterance symmetric int8 with a float scale, dequantized on the card
  at the top of the train step into the compute dtype. 4x fewer
  host-to-device bytes than float32.
- `DeviceFeatureCache`: every utterance of the train set loaded, CMVN'd and
  (at int8) quantized once, uploaded once, and each step's minibatch
  assembled on the card by an index by utterance row (`gather_features`),
  so a step moves only token ids and row indices to the card.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from stjep_tpu_torch.ops.masks import bucket_length, round_up8

_TORCH_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32}


def feat_storage_dtype(feat_dtype) -> torch.dtype:
    """The torch dtype a staging dtype name or numpy dtype stores as
    ("bfloat16", "int8", np.float32, ...)."""
    if feat_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if isinstance(feat_dtype, torch.dtype):
        return feat_dtype
    return _TORCH_DTYPE[np.dtype(feat_dtype)]


def estimate_corpus_bytes(dataset, acous_bucket: int, feat_dtype) -> int:
    """Bytes DeviceFeatureCache.build would allocate for `dataset` at
    `feat_dtype`, WITHOUT loading any features: n x bucketed-T_max x D x
    itemsize (+ per-row f32 scales when int8). D is read from the first npy
    header via mmap."""
    flis = dataset.train_acous_flis
    lens = dataset.train_acous_lengths
    if not flis or not any(flis):
        return 0
    t_max = bucket_length(int(round_up8(max(lens))), acous_bucket)
    probe = np.load(flis[0], mmap_mode="r")
    d = probe.shape[1]
    del probe
    dtype = feat_storage_dtype(feat_dtype)
    n = len(flis)
    nbytes = n * t_max * d * dtype.itemsize
    if dtype == torch.int8:
        nbytes += n * 4  # f32 scales
    return nbytes


def hbm_cache_budget(fraction: float = 0.5, device="cuda") -> int:
    """Free device memory for a resident feature cache, in bytes:
    `fraction` of what torch.cuda.mem_get_info reports free, leaving room
    for params, activations and gradients. STJEP_CACHE_BUDGET_MB
    overrides it; without a card the budget is 0."""
    env = os.environ.get("STJEP_CACHE_BUDGET_MB")
    if env:
        return int(float(env) * 2 ** 20)
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 0
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * fraction)


def quantize_batch(feats: np.ndarray, scale_dtype) -> Dict[str, np.ndarray]:
    """Per-utterance symmetric int8 quantization.

    feats: [..., B, T, D] float array; the last two axes are the utterance.
    Returns {"q": int8 like feats, "scale": scale_dtype [..., B]} with
    dequantization q * scale[..., None, None] in the scale's dtype.
    """
    amax = np.max(np.abs(feats), axis=(-2, -1))
    scale = (amax / 127.0).astype(np.float32)
    safe = np.where(scale == 0.0, 1.0, scale)
    q = np.rint(feats / safe[..., None, None])
    q = np.clip(q, -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(scale_dtype)}


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=None) -> torch.Tensor:
    """The inverse of quantize_batch on the card, into `dtype` (the
    compute dtype; default the scale's)."""
    dtype = dtype or scale.dtype
    return q.to(dtype) * scale.to(dtype)[..., None, None]


class DeviceFeatureCache:
    """Whole-corpus acoustic features resident on the card.

    feats: [N, T_max, D] tensor, int8 when quantized, else the staging
           float dtype; scale: [N] f32 tensor, or None when unquantized.
    T_max is pre-bucketed so every batch's bucketed length slices inside it.
    """

    def __init__(self, feats, scale, row_of_path: Dict[str, int], t_max: int,
                 nbytes: int):
        self.feats = feats
        self.scale = scale
        self._row = row_of_path
        self.t_max = t_max
        self.nbytes = nbytes

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        out = {"feats": self.feats}
        if self.scale is not None:
            out["scale"] = self.scale
        return out

    def rows(self, flis: List[str]) -> np.ndarray:
        return np.asarray([self._row[f] for f in flis], np.int32)

    @classmethod
    def build(cls, dataset, acous_bucket: int, feat_dtype, device="cuda",
              chunk: int = 64, logger=None):
        """Load + CMVN + (maybe) quantize every utterance of `dataset` and
        upload it to `device` once. feat_dtype: int8 for quantized storage,
        else the float staging dtype (float32 / "bfloat16")."""
        flis = dataset.train_acous_flis
        lens = dataset.train_acous_lengths
        spks = dataset.train_acous_spkids
        if not flis:
            raise ValueError("device cache: dataset has no acoustics")
        n = len(flis)
        t_max = bucket_length(int(round_up8(max(lens))), acous_bucket)
        dtype = feat_storage_dtype(feat_dtype)
        quant = dtype == torch.int8
        probe = np.load(flis[0], mmap_mode="r")
        d = probe.shape[1]
        del probe

        buf = torch.zeros((n, t_max, d), dtype=dtype)
        scales = torch.zeros((n,), dtype=torch.float32) if quant else None
        for st in range(0, n, chunk):
            ed = min(st + chunk, n)
            norm = (dataset.load_mu_std(spks[st:ed])
                    if dataset.acous_norm else None)
            arr = dataset.load_acous(flis[st:ed], norm_param=norm,
                                     lengths=lens[st:ed])  # [m, t_chunk, D]
            t = min(arr.shape[1], t_max)
            if quant:
                qd = quantize_batch(arr[:, :t], np.float32)
                buf[st:ed, :t] = torch.from_numpy(qd["q"])
                scales[st:ed] = torch.from_numpy(qd["scale"])
            else:
                buf[st:ed, :t] = torch.from_numpy(arr[:, :t]).to(dtype)
        feats = buf.to(device)
        scale = scales.to(device) if quant else None
        nbytes = buf.numel() * buf.element_size() + (scales.numel() * 4 if quant else 0)
        if logger is not None:
            logger.info("device feature cache: %d utterances, [%d, %d, %d] %s "
                        "(%.1f MB on %s)", n, n, t_max, d, dtype,
                        nbytes / 2 ** 20, device)
        return cls(feats, scale, {f: i for i, f in enumerate(flis)}, t_max, nbytes)


def gather_features(cache_arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                    t_bucket: int, dtype=torch.float32) -> torch.Tensor:
    """Minibatch assembly from a resident cache, on the cache's device: the
    rows `idx`, the time axis cut to `t_bucket`, dequantized (or cast) to
    the compute `dtype`."""
    idx = idx.long()
    raw = cache_arrays["feats"].index_select(0, idx)[:, :t_bucket]
    if "scale" in cache_arrays:
        return dequantize(raw, cache_arrays["scale"].index_select(0, idx), dtype)
    return raw.to(dtype)
