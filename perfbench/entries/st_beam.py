"""The ST beam decode runner: closed loop, one caller, the next batch when
the last one's tokens are on the host. Each call is the program's
`stjep_tpu_torch.infer.forward.forward_translate(mode="ST")` on host
features. What it computes on the way is kept by recording wrappers
(references only: no copy, no device work): the LAS hypotheses and
dynamic embeddings (`forward._las_pass`), the served row's score
(`forward.beam_search`), and before each beam position from the second on
the kept hypotheses and their scores (the `preds` and `scores` that
`beam.decode_beam_step_flash` or `beam.beam_select` take).

After the window the comparison holds `check_batches` batches, drawn from
the seed over the window, and the ASR hypotheses of every pool batch, to
the plain reference (checks.decode_numbers).

The ST head's EOS column is held at zero (`hold_eos`), so every batch
decodes max_seq_len positions: with random weights the EOS logit's rank,
and with it a batch's positions, would depend on the draw. The beam's EOS
bookkeeping is therefore neither timed nor compared here."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import checks, traffic as traffic_mod
from perfbench.tracing import Recorder, arg, result
from perfbench.weights import draw_params

UNIT = "batch"
EOS = 3


def hold_eos(params: Dict):
    """The ST head's EOS logit held at 0, far below the top K of the other
    logits: no beam ends before max_seq_len, whatever the draw."""
    params["out_tgt"]["w"][:, EOS] = 0.0


def kept_state(args: Dict, out):
    """Position i's input: the kept hypotheses [B*K, Lbuf] and their scores."""
    return (int(arg(args, "i")), arg(args, "preds", 2, torch.int32),
            arg(args, "scores", 1, torch.float32))


def setup(run) -> Dict:
    from stjep_tpu_torch.config import ModelConfig
    import stjep_tpu_torch.infer.beam as beam
    import stjep_tpu_torch.infer.forward as fwd

    tr, model = run.traffic, run.model
    cfg = ModelConfig(**{**model, "mode": tr["mode"]})
    params = draw_params(model, run.seed, run.device)
    hold_eos(params)
    pool = traffic_mod.make_pool(tr, model, run.seed)
    feats = [(torch.from_numpy(b["acous_feat"]), torch.from_numpy(b["acouslen"]))
             for b in pool]
    st = {"cfg": cfg, "params": params, "pool": pool, "feats": feats, "outputs": [], "hold": 0,
          "las": Recorder(fwd, "_las_pass"), "beam": Recorder(fwd, "beam_search"),
          "steps": [Recorder(beam, "decode_beam_step_flash", keep=kept_state),
                    Recorder(beam, "beam_select", keep=kept_state)]}
    call(run, st)  # warm-up: every shape of the traffic (one frame axis)
    st["outputs"].clear()
    st["hold"] = tr["check_batches"]
    return st


def call(run, st: Dict) -> int:
    """One request batch: host features in, tokens on the host out. The
    batch's ASR hypotheses and served score come to the host with its
    tokens (the tokens' read already waited for the device); its dynamic
    embeddings and kept states stay on the card until `keep` decides:
    in the window after the call, elsewhere (a traced stretch, the
    control's readings) at its end, where the first `hold` calls are the
    comparison's sample."""
    from stjep_tpu_torch.infer.forward import forward_translate

    tr = run.traffic
    i = st.setdefault("k", 0) % len(st["feats"])
    st["k"] += 1
    f, lens = st["feats"][i]
    toks = forward_translate(st["params"], st["cfg"], "ST", acous_feats=f, acous_lens=lens,
                             beam_width=tr["beam"], penalty_factor=tr["penalty"],
                             max_seq_len=tr["max_seq_len"], device=run.device).cpu()
    las, beam = st["las"].calls.pop(), st["beam"].calls.pop()
    steps = []
    for rec in st["steps"]:
        steps += rec.calls
        rec.calls.clear()
    st["outputs"].append({"pool": i, "tokens": toks, "hyps": result(las, 1, 2).cpu(),
                          "scores": result(beam, 1, 1).cpu(), "emb": result(las, 0, 3),
                          "steps": steps})
    if st["hold"] is not None:
        keep(st["outputs"][-1], sum("emb_host" in o for o in st["outputs"]) < st["hold"])
    return f.shape[0]


def keep(out: Dict, held: bool, picked: bool = False):
    """A batch's dynamic embeddings and kept states go to the host if the
    comparison may hold the batch, and are dropped otherwise, so the card
    keeps none of them past their batch."""
    emb, steps = out.pop("emb"), out.pop("steps")
    if held:
        out["emb_host"], out["picked"] = emb.cpu(), picked
        out["steps_host"] = [(i, p.cpu(), s.cpu()) for i, p, s in steps]


def window(run, st: Dict, seconds: float) -> Dict:
    """The closed loop over `seconds`. The comparison's sample is drawn from
    the seed once the first batch's time gives the window's expected count;
    the latest batch stands in for a pick the window does not reach."""
    rng = np.random.default_rng(int(run.seed) + 1)
    st["hold"] = None  # the window decides
    t0 = time.perf_counter()
    done = k = 0
    pick = None
    while True:
        done += call(run, st)
        now = time.perf_counter() - t0
        if pick is None:
            n_est = max(1, int(seconds / now))
            pick = set(rng.choice(n_est, size=min(run.traffic["check_batches"], n_est),
                                  replace=False).tolist())
        k += 1
        if now >= seconds:
            break
        keep(st["outputs"][-1], k - 1 in pick, k - 1 in pick)
    elapsed = time.perf_counter() - t0
    keep(st["outputs"][-1], True)
    return {"decode_utt_per_s": done / elapsed, "_units": k, "_elapsed": elapsed}


def stretch_extra(run, st: Dict, n: int) -> Dict:
    """Per traced batch: its beam positions and its model FLOPs."""
    from stjep_tpu_torch.utils.profiling import launch_counts

    got = launch_counts()
    positions = sum(v for key, v in got.items()
                    if key.split()[0] in ("K3", "K4") and key != "K4 select"
                    or key == "K7 head")
    tr, model = run.traffic, run.model
    flops = 0.0
    for out in st["outputs"][-n:]:
        f, lens = st["feats"][out["pool"]]
        mem_rows = int(checks.las_lengths(out["hyps"].cpu(), model["max_seq_len_src"]).sum())
        parts = run.yardstick.decode_flop_parts(
            model, lens.tolist(), f.shape[1], model["max_seq_len_src"] - 1,
            model["max_seq_len_src"] - 1, positions // n, tr["beam"], mem_rows)
        flops += sum(parts.values())
    return {"positions": positions, "flops": flops}


def sample(run, st: Dict) -> List[Dict]:
    """The batches the comparison holds: those the window drew from the
    seed (every batch holds the traffic's longest utterance), the last
    batch standing in for picks the window did not reach; outside a window,
    the first calls."""
    held = [o for o in st["outputs"] if "emb_host" in o]
    picked = [o for o in held if o["picked"]]
    return (picked + [o for o in reversed(held) if not o["picked"]])[:run.traffic["check_batches"]]


def check(run, st: Dict, control: bool = False):
    """The decode numbers; with control, (the program's, the control's)."""
    for rec in [st["las"], st["beam"], *st["steps"]]:
        rec.remove()
    return checks.decode_numbers(run.model, st["params"], st["feats"], st["outputs"],
                                 sample(run, st), run.traffic["beam"], run.device,
                                 control=control)
