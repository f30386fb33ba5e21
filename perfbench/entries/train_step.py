"""The training runner: one object, the program's step from
`stjep_tpu_torch.train.trainer.make_train_step(cfg, mode, optimizer)` with
its params and Adam state, driven through its first `check_steps` steps
(the steps the comparison follows, with dropout and SpecAugment on, as
every timed step runs), then the window. Each step stages its batch from
the host pool as the Trainer does (data/loader.py to_device: pinned,
non-blocking copies) and records a CUDA event when it is issued; no step
waits for the device. After the window the events give each step's time
(the interval between consecutive completion events).

In the checked steps recording wrappers keep each step's random draws:
every uniform draw behind a dropout mask (`ops.transformer.uniform`, also
as `models.las_decoder` imports it) with its batch dim, and SpecAugment's
band mask (from `models.las_encoder.spec_augment`'s input and output). The
reference takes them as data and applies them where the reference model
puts its regularisers (reference.stjep.Drops)."""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import checks, traffic as traffic_mod
from perfbench.reference.stjep import Drops
from perfbench.tracing import Recorder, arg
from perfbench.weights import draw_params, leaf_paths

UNIT = "step"


def _host(t):
    return t.detach().to("cpu", copy=True)


def _draw(args: Dict, out):
    return out, int(arg(args, "batch_dim"))


def _spec_keep(args: Dict, out):
    """SpecAugment's keep mask [T, C]: where no row kept a nonzero feature."""
    x = arg(args, "acous_feats", 3)
    return ~((out == 0) & (x != 0)).any(0)


class draws:
    """Inside the block, each step's draws are kept; `take()` hands them to
    the host as the reference's Drops data for one step."""

    def __init__(self, rate: float):
        self.rate = rate

    def __enter__(self):
        import stjep_tpu_torch.models.las_decoder as las_dec
        import stjep_tpu_torch.models.las_encoder as las_enc
        import stjep_tpu_torch.ops.transformer as tfm

        self.recs = [Recorder(tfm, "uniform", keep=_draw),
                     Recorder(las_dec, "uniform", keep=_draw),
                     Recorder(las_enc, "spec_augment", keep=_spec_keep)]
        self.recs[1].calls = self.recs[0].calls  # one list, in the order drawn
        return self

    def take(self) -> Dict:
        got = {"draws": [(_host(u), bd) for u, bd in self.recs[0].calls],
               "spec_keep": _host(self.recs[2].calls[-1]) if self.recs[2].calls else None,
               "rate": self.rate}
        self.recs[0].calls.clear()
        self.recs[2].calls.clear()
        return got

    def __exit__(self, *exc):
        for r in reversed(self.recs):
            r.remove()


def setup(run) -> Dict:
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import make_train_step

    tr, model = run.traffic, run.model
    cfg = ModelConfig(**{**model, "mode": tr["mode"], "dropout": tr["dropout"],
                         "spec_aug": tr["spec_aug"]})
    params = draw_params(model, run.seed, run.device)
    pool = traffic_mod.make_pool(tr, model, run.seed)
    optimizer = make_optimizer(tr["max_grad_norm"])
    st = {"cfg": cfg, "params": params, "pool": pool, "opt": optimizer.init(params),
          "step": make_train_step(cfg, tr["mode"], optimizer, device=run.device),
          "root": np.random.default_rng(int(run.seed) + 2), "k": 0, "events": []}
    # the steps the comparison follows, as the window runs them
    losses, grad1, drops = [], None, []
    with draws(tr["dropout"]) as rec:
        for k in range(tr["check_steps"]):
            losses.append(call(run, st))
            t1 = time.perf_counter()
            drops.append(rec.take())
            if k == 0:
                grad1 = [_host(st["opt"].state.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                         / 0.1 for p in st["opt"].param_groups[0]["params"]]
            run.check_seconds += time.perf_counter() - t1
    t1 = time.perf_counter()
    change = [_host(t) for _, t in leaf_paths(params)]
    st["prog"] = {"losses": [{k: float(v) for k, v in ls.items()} for ls in losses],
                  "grad1": grad1, "change": change}
    st["drops"] = drops
    run.check_seconds += time.perf_counter() - t1
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    st["events"].clear()
    return st


def step_drops(st: Dict, rows=None) -> List[Drops]:
    """The checked steps' draws as the reference's Drops, each step's
    batch cut to its first `rows` where given."""
    return [Drops(d["draws"], d["spec_keep"], d["rate"], rows) for d in st["drops"]]


def call(run, st: Dict):
    """One step on the next pool batch; returns its loss dict (device
    scalars)."""
    from stjep_tpu_torch.data.loader import to_device

    pool = st["pool"]
    mb = to_device(pool[st["k"] % len(pool)], run.device)
    gen = torch.Generator().manual_seed(int(st["root"].integers(0, 2 ** 62)))
    _, _, losses = st["step"](st["params"], st["opt"], [mb], gen, run.traffic["lr"])
    st["k"] += 1
    if run.device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        st["events"].append(ev)
    return losses


def window(run, st: Dict, seconds: float) -> Dict:
    cuda = run.device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    n = 0
    while True:
        call(run, st)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    out = {"train_samples_per_s": n * run.traffic["batch"] / elapsed, "_units": n,
           "_elapsed": elapsed}
    if cuda:
        evs = [start] + st["events"][-n:]
        times = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        out["train_step_p95_ms"] = float(np.percentile(times, 95))
        out["_step_ms"] = times
    return out


def stretch_extra(run, st: Dict, n: int) -> Dict:
    """The traced steps' model FLOPs."""
    tr, model, y = run.traffic, run.model, run.yardstick
    b = st["pool"][0]
    if tr["mode"] == "MT":
        flops = sum(y.mt_train_flop_parts(model, tr["batch"], tr["pad_src"],
                                          tr["pad_tgt"]).values())
    else:
        flops = sum(y.analytic_train_flop_parts(model, tr["batch"], b["acous_feat"].shape[1],
                                                tr["pad_src"], tr["pad_tgt"],
                                                lens=b["acouslen"].tolist()).values())
    return {"flops": n * flops}


def check(run, st: Dict) -> Dict[str, float]:
    tr = run.traffic
    params0 = draw_params(run.model, run.seed, run.device)
    start = [t.detach().clone() for _, t in leaf_paths(params0)]
    batches = [{k: torch.from_numpy(v).to(run.device) for k, v in st["pool"][i].items()}
               for i in range(tr["check_steps"])]
    try:
        want = checks.reference_steps(run.model, tr["mode"], params0, batches, tr["lr"],
                                      tr["max_grad_norm"], drops=step_drops(st))
    except ValueError as e:  # the program drew for other shapes than the batches' sites
        print(f"perfbench: the reference cannot follow the checked steps: {e}", file=sys.stderr)
        return dict.fromkeys(("loss_err", "grad_err", "change_err"), checks.MISS)
    prog = {**st["prog"], "change": [c.to(run.device) - s
                                     for c, s in zip(st["prog"]["change"], start)]}
    return checks.train_numbers(prog, want)
