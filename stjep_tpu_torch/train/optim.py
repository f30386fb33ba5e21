"""Optimizer: global-norm clip, Adam with torch's defaults, and the
reference LR schedule (port of stjep_tpu/train/optim.py).

The JAX package chains optax.clip_by_global_norm -> scale_by_adam(0.9,
0.999, 1e-8) -> -lr, with the LR written into the state every step. Here
the clip is written out as optax computes it (`g * max_norm / norm` only
when norm >= max_norm; torch's clip_grad_norm_ adds 1e-6 to the norm), and
Adam is `torch.optim.Adam`, the same update, which steps the parameters in
place; its moments take each parameter's dtype, as optax's do (bf16 under
bf16 params).

Freezing (`trainable_mask`, a tree of bools like the params, True =
trainable): JAX wraps the chain in `optax.multi_transform` with
`set_to_zero` for frozen leaves, so the clip's global norm is taken over
the trainable leaves only, and frozen leaves get no update and no Adam
state. Here Adam holds only the trainable leaves and the clip reads only
their gradients.

`state_tree` / `load_state_tree` map the Adam state to optax's state tree,
leaf by leaf (the clip's empty state, scale_by_adam's count/mu/nu, the
injected step_size, under multi_transform's "train"/"freeze" branches when
there is a mask), which is what a checkpoint stores.

On the Trainer's mesh the params come in parallel/mesh.py's training
layout: Adam runs over a split leaf's slices, each a parameter of its own
(elementwise, so a slice's update is the unsharded leaf's slice), the
clip's global norm sums the squares over every slice and takes one square
root, and the freezing mask applies to a leaf's slices by the leaf's path.
`state_tree` joins the slices' moments and `load_state_tree` cuts them, so
the state tree keeps optax's unsharded layout whatever the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from stjep_tpu_torch.bridge import leaves
from stjep_tpu_torch.parallel.mesh import Shards, like_layout, logical_leaves, shard_dim
from stjep_tpu_torch.utils.profiling import span


def reference_lr(step, init_lr: float, peak_lr: float,
                 warmup_steps: int) -> float:
    """ref: trainer_base.py:135-154. Pure host math, called every step:
    warmup_steps <= 0 keeps init_lr; up to warmup_steps the LR moves
    linearly from init_lr to peak_lr (downward when peak < init); after it
    decays as peak * step^-0.5 * warmup^0.5."""
    if warmup_steps <= 0:
        return float(init_lr)
    step = float(step)
    if step <= warmup_steps:
        return step * (peak_lr - init_lr) / warmup_steps + init_lr
    return peak_lr * max(step, 1.0) ** -0.5 * warmup_steps ** 0.5


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    max_norm, else each t / norm * max_norm. No host sync. Gradients on
    several devices: the squares are summed on the first one's."""
    dev = grads[0].device
    norm = torch.sqrt(sum(torch.sum(g * g).to(dev) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep.to(g.device), g, g / norm.to(g.device) * max_norm)
            for g in grads]


def _map_tree(tree: Any, fn, it) -> Any:
    """The structure of `tree` with each leaf (a Shards counting as one)
    replaced by fn(next(it))."""
    if isinstance(tree, Shards):
        return fn(next(it))
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, it) for v in tree)
    return fn(next(it))


class Optimizer:
    """clip -> Adam, in place on the trainable leaves of a params tree."""

    def __init__(self, max_grad_norm: float = 1.0,
                 trainable_mask: Optional[Any] = None):
        self.max_grad_norm = max_grad_norm
        self.mask = trainable_mask
        self.trainable = (None if trainable_mask is None
                          else [bool(m) for m in leaves(trainable_mask)])
        self._keep = self.trainable  # per leaf of the params init() took

    def _keep_of(self, params: Dict) -> Optional[List[bool]]:
        """The mask per leaf of params (a split leaf's slices take its value)."""
        if self.mask is None:
            return None
        return [bool(m) for m in leaves(like_layout(self.mask, params))]

    @property
    def clips(self) -> bool:
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    def _select(self, xs: List) -> List:
        if self._keep is None:
            return list(xs)
        return [x for x, keep in zip(xs, self._keep, strict=True) if keep]

    def init(self, params: Dict) -> torch.optim.Adam:
        """The optimizer state: Adam over the tree's trainable leaves (a
        split leaf's slices), LR 0 until set_lr writes it. `update` then
        takes the gradients of this tree's leaves."""
        self._keep = self._keep_of(params)
        return torch.optim.Adam(self._select(leaves(params)), lr=0.0,
                                betas=(0.9, 0.999), eps=1e-8)

    def update(self, grads: List[torch.Tensor], opt_state: torch.optim.Adam):
        """One step from grads, in the order of bridge.leaves(params);
        frozen leaves' gradients are ignored. The update is the span
        `stjep.train.optimizer` (utils/profiling.py)."""
        with span("stjep.train.optimizer"):
            grads = self._select(grads)
            if self.clips:
                grads = clip_by_global_norm(grads, self.max_grad_norm)
            ps = opt_state.param_groups[0]["params"]
            for p, g in zip(ps, grads, strict=True):
                p.grad = g
            opt_state.step()
            for p in ps:
                p.grad = None

    # ------------------------------------------------ optax's state tree

    def state_tree(self, params: Dict, opt_state: torch.optim.Adam) -> Dict:
        """The state as `make_optimizer(max_grad_norm, mask).init(params)`
        lays it out in the JAX package after as many updates (tensors on the
        host; frozen leaves' moments are `{}`, optax's MaskedNode); a split
        leaf's moments joined in shard order, so the tree is the unsharded
        one."""
        pairs = logical_leaves(params)
        keep = self.trainable or [True] * len(pairs)
        count = 0
        moments = {"mu": [], "nu": []}
        for (name, p), k in zip(pairs, keep, strict=True):
            parts = list(p) if isinstance(p, Shards) else [p]
            sts = [opt_state.state.get(x, {}) if k else None for x in parts]
            if sts[0]:
                count = int(sts[0]["step"])
            for key, attr in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                if not k:
                    moments[key].append({})
                    continue
                vals = [(st[attr] if st else torch.zeros_like(x)).detach().cpu()
                        for st, x in zip(sts, parts)]
                moments[key].append(torch.cat(vals, shard_dim(name))
                                    if isinstance(p, Shards) else vals[0])
        n = torch.tensor(count, dtype=torch.int32)
        adam = {"count": n}
        for key, vals in moments.items():
            adam[key] = _map_tree(params, lambda v: v, iter(vals))
        lr = float(opt_state.param_groups[0]["lr"])
        inject = {"count": n.clone(),
                  "hyperparams": {"step_size": torch.tensor(-lr, dtype=torch.float32)},
                  "hyperparams_states": {}, "inner_state": {}}
        chain = [{}, adam, inject] if self.clips else [adam, inject]
        chain = {str(i): s for i, s in enumerate(chain)}
        if self.mask is None:
            return chain
        return {"inner_states": {"freeze": {"inner_state": {}},
                                 "train": {"inner_state": chain}}}

    def load_state_tree(self, params: Dict, opt_state: torch.optim.Adam,
                        tree: Dict):
        """Set Adam's state (count, moments, LR) from a state tree of
        `state_tree`'s layout, in place; lists may come as dicts keyed "0",
        "1", ... (a checkpoint's state dict). A split leaf's moments are cut
        into its slices."""
        if self.mask is not None:
            tree = tree["inner_states"]["train"]["inner_state"]
        adam, inject = (tree["1"], tree["2"]) if self.clips else (tree["0"], tree["1"])
        count = int(torch.as_tensor(adam["count"]))
        pairs = logical_leaves(params)
        keep = self.trainable or [True] * len(pairs)
        for (name, p), k in zip(pairs, keep, strict=True):
            if not k:
                continue
            mu, nu = (torch.as_tensor(_lookup(adam[key], name)) for key in ("mu", "nu"))
            if isinstance(p, Shards):
                dim = shard_dim(name)
                cuts = list(zip(p, *(torch.split(t, [x.shape[dim] for x in p], dim)
                                     for t in (mu, nu))))
            else:
                cuts = [(p, mu, nu)]
            for x, m, v in cuts:
                opt_state.state[x] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": m.to(device=x.device, dtype=x.dtype).clone(),
                    "exp_avg_sq": v.to(device=x.device, dtype=x.dtype).clone()}
        set_lr(opt_state, -float(torch.as_tensor(inject["hyperparams"]["step_size"])))


def _lookup(tree: Any, name: str):
    """The leaf at bridge path `name` ("/a/0/w") of a tree whose lists may
    be stored as dicts keyed "0", "1", ... (a checkpoint's state dict)."""
    for part in name.strip("/").split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def make_optimizer(max_grad_norm: float = 1.0,
                   trainable_mask: Optional[Any] = None) -> Optimizer:
    """clip-by-global-norm (when max_grad_norm > 0) -> Adam (torch
    defaults), over the leaves `trainable_mask` marks True (all without a
    mask); the LR lives in the state, written by set_lr."""
    return Optimizer(max_grad_norm, trainable_mask)


def set_lr(opt_state: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    """Write the learning rate for the next update (the reference writes
    param_group['lr'] every step)."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state
