"""Checkpoint manager: msgpack checkpoints in timestamped dirs (port of
stjep_tpu/train/checkpoint.py).

Same directory discipline as the JAX package's and the reference's
(ref: modules/checkpoint.py:11-209): timestamped subdirs under
<expt>/checkpoints (or <expt>/checkpoints_epoch/<n>), keep_num pruning,
latest/2nd/3rd-latest lookup, and checkpoint weight averaging
(ref: utils/misc.py:94-113). The files are the JAX package's:
params.msgpack and opt_state.msgpack in flax's msgpack format
(`flax_msgpack.py`), meta.json and the vocab JSONs, so either package loads
the other's checkpoints. `opt_state` here is optax's state tree as
`Optimizer.state_tree` gives it. Under a process group every rank calls
the writes, rank 0 alone touches the filesystem, and a barrier follows,
so a load right after sees a complete dir (JAX :76-106); the params are
replicated over the ranks, so each holds the whole tree to write already.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

import torch

from stjep_tpu_torch.parallel import distributed
from stjep_tpu_torch.train import flax_msgpack
from stjep_tpu_torch.train.policies import get_path, has_path, map_with_path

CHECKPOINT_DIR_NAME = "checkpoints"
CHECKPOINT_EPOCH_DIR_NAME = "checkpoints_epoch"
PARAMS_NAME = "params.msgpack"
OPT_NAME = "opt_state.msgpack"
META_NAME = "meta.json"
INPUT_VOCAB_FILE = "input_vocab.json"
OUTPUT_VOCAB_FILE = "output_vocab.json"


class Checkpoint:
    """Bundle of (params, opt_state, epoch, step, vocabs) with save/load."""

    def __init__(self, params, opt_state=None, epoch: int = 0, step: int = 0,
                 input_vocab=None, output_vocab=None, path: Optional[str] = None,
                 model_config: Optional[Dict] = None):
        self.params = params
        self.opt_state = opt_state
        self.epoch = epoch
        self.step = step
        self.input_vocab = input_vocab or []
        self.output_vocab = output_vocab or []
        self.model_config = model_config
        self._path = path

    @property
    def path(self) -> str:
        if self._path is None:
            raise LookupError("The checkpoint has not been saved.")
        return self._path

    # ----------------------------------------------------------- saving

    def _write(self, path: str) -> str:
        """Write the checkpoint dir: collective under a process group (module
        docstring)."""
        if distributed.is_primary():
            if os.path.exists(path):
                shutil.rmtree(path)
            os.makedirs(path)
            with open(os.path.join(path, PARAMS_NAME), "wb") as f:
                f.write(flax_msgpack.to_bytes(self.params))
            if self.opt_state is not None:
                with open(os.path.join(path, OPT_NAME), "wb") as f:
                    f.write(flax_msgpack.to_bytes(self.opt_state))
            with open(os.path.join(path, META_NAME), "w") as f:
                json.dump({"epoch": self.epoch, "step": self.step,
                           "model_config": self.model_config}, f)
            with open(os.path.join(path, INPUT_VOCAB_FILE), "w") as f:
                json.dump(list(self.input_vocab), f)
            with open(os.path.join(path, OUTPUT_VOCAB_FILE), "w") as f:
                json.dump(list(self.output_vocab), f)
        distributed.barrier("ckpt_write:" + path)
        self._path = path
        return path

    def save(self, experiment_dir: str) -> str:
        """Timestamped dir (ref: checkpoint.py:54-83); a microsecond suffix
        keeps names unique and lexicographically ordered."""
        # ONE clock read for both parts: a second read can straddle a second
        # rollover and emit old-second + new-microseconds, which sorts
        # BEFORE the previous checkpoint and breaks the latest lookups;
        # rank 0's read on every rank, so the ranks name the same dir
        now = time.time()
        if distributed.world_size() > 1:
            t = torch.tensor([now if distributed.is_primary() else 0.0], dtype=torch.float64)
            now = float(distributed.all_reduce_sum(t)[0])
        date_time = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime(now))
        date_time += "_{:06d}".format(int((now % 1) * 1e6))
        return self._write(os.path.join(experiment_dir, CHECKPOINT_DIR_NAME, date_time))

    def save_epoch(self, experiment_dir: str, epoch: int) -> str:
        """Per-epoch dirs when training without a dev set
        (ref: checkpoint.py:85-113)."""
        return self._write(
            os.path.join(experiment_dir, CHECKPOINT_EPOCH_DIR_NAME, str(epoch)))

    def save_customise(self, dir_path: str) -> str:
        """ref: checkpoint.py:115-136."""
        return self._write(dir_path)

    def rm_old(self, experiment_dir: str, keep_num: int = 3):
        """Prune to keep_num newest (ref: checkpoint.py:138-148); rank 0
        alone under a process group."""
        if not distributed.is_primary():
            return
        checkpoints_path = os.path.join(experiment_dir, CHECKPOINT_DIR_NAME)
        all_times = sorted(os.listdir(checkpoints_path), reverse=True)
        for name in all_times[keep_num:]:
            shutil.rmtree(os.path.join(checkpoints_path, name))

    # ---------------------------------------------------------- loading

    @classmethod
    def load(cls, path: str, params_template=None, with_opt_state: bool = False):
        """Load a checkpoint dir, arrays as CPU tensors in their stored
        dtypes. With a params template (a nested dict/list tree) the params
        take its structure, else they come as the raw state dict (lists as
        dicts keyed "0", "1", ...). with_opt_state reads opt_state.msgpack
        as a raw state dict (optax's tree, see Optimizer.load_state_tree)
        when the file exists."""
        with open(os.path.join(path, PARAMS_NAME), "rb") as f:
            raw = f.read()
        params = (flax_msgpack.from_bytes(params_template, raw)
                  if params_template is not None else flax_msgpack.msgpack_restore(raw))
        opt_state = None
        opt_path = os.path.join(path, OPT_NAME)
        if with_opt_state and os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                opt_state = flax_msgpack.msgpack_restore(f.read())
        meta = {"epoch": 0, "step": 0}
        meta_path = os.path.join(path, META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        vin: List[str] = []
        vout: List[str] = []
        if os.path.exists(os.path.join(path, INPUT_VOCAB_FILE)):
            with open(os.path.join(path, INPUT_VOCAB_FILE)) as f:
                vin = json.load(f)
            with open(os.path.join(path, OUTPUT_VOCAB_FILE)) as f:
                vout = json.load(f)
        return cls(params, opt_state=opt_state, epoch=meta["epoch"],
                   step=meta["step"], input_vocab=vin, output_vocab=vout,
                   path=path, model_config=meta.get("model_config"))

    @classmethod
    def _nth_latest(cls, experiment_path: str, n: int) -> str:
        checkpoints_path = os.path.join(experiment_path, CHECKPOINT_DIR_NAME)
        all_times = sorted(os.listdir(checkpoints_path), reverse=True)
        return os.path.join(checkpoints_path, all_times[n])

    @classmethod
    def get_latest_checkpoint(cls, experiment_path: str) -> Optional[str]:
        """ref: checkpoint.py:183-195."""
        checkpoints_path = os.path.join(experiment_path, CHECKPOINT_DIR_NAME)
        if not os.path.isdir(checkpoints_path) or not os.listdir(checkpoints_path):
            return None
        return cls._nth_latest(experiment_path, 0)

    @classmethod
    def get_secondlast_checkpoint(cls, experiment_path: str) -> str:
        return cls._nth_latest(experiment_path, 1)

    @classmethod
    def get_thirdlast_checkpoint(cls, experiment_path: str) -> str:
        return cls._nth_latest(experiment_path, 2)


def upgrade_params(raw, template, logger=None):
    """Fill params missing from an older checkpoint with template values
    (the reference's `check_var` back-compat shim, ref:
    models/Seq2seq.py:906-914): any leaf present in the template but absent
    from the loaded tree (or of another shape) keeps its template value;
    loaded leaves take the template leaf's dtype and device."""

    def fn(name, leaf):
        path = tuple(name.split("."))
        if has_path(raw, path):
            cand = get_path(raw, path)
            if tuple(cand.shape) == tuple(leaf.shape):
                return torch.as_tensor(cand).to(device=leaf.device, dtype=leaf.dtype)
        if logger is not None:
            logger.info("checkpoint missing %s - keeping initialised value", name)
        return leaf

    return map_with_path(template, fn)


def combine_weights(path: str, params_template=None):
    """Average all checkpoints under `path` leaf-wise, in float64, back in
    each leaf's dtype (ref: utils/misc.py:94-113)."""
    trees = [Checkpoint.load(os.path.join(path, d), params_template=params_template).params
             for d in sorted(os.listdir(path))]
    n = float(len(trees))

    def avg(*xs):
        if isinstance(xs[0], dict):
            return {k: avg(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], (list, tuple)):
            return type(xs[0])(avg(*ys) for ys in zip(*xs))
        return (sum(x.double() for x in xs) / n).to(xs[0].dtype)

    return avg(*trees)


def log_ckpts(ckpt_path: str, out_path: str):
    """ref: utils/misc.py:116-121."""
    with open(os.path.join(out_path, "ckpts.log"), "w") as f:
        for ckpt in sorted(os.listdir(ckpt_path)):
            f.write("{}\n".format(ckpt))
