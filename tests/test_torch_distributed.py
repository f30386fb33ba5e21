"""Data parallelism across processes in the port (stjep_tpu_torch/parallel/
distributed.py, the process axis of parallel/mesh.py, train/trainer.py's
cut and sum, train/checkpoint.py's collective writes), on the CPU.

The helpers are held to the JAX package's on the same inputs, with the
process count and index patched on both sides. Two ranks run on gloo
through stjep_tpu_torch/scripts/multiproc_worker.py with a `file://`
rendezvous, once for the module, and are held to the one-process port step
(dropout off, and dropout 0.2 with SpecAugment on: one generator, each
rank's draws its rows of the whole minibatch's) with the loss within 1e-5
relative and each gradient leaf within 1e-5 of its norm; with dropout off
also to JAX's single-device Trainer step (tests/test_torch_mesh_train.py's
`jax_step`) at rtol 1e-5 / atol 1e-6, that file's band. The ranks' params
and Adam states are compared by digest (bit for bit).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from stjep_tpu.config import ModelConfig as JConfig
from stjep_tpu.models.seq2seq import init_seq2seq as jinit
from stjep_tpu.parallel import distributed as jdist

from stjep_tpu_torch.bridge import named_leaves, params_from_numpy
from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops import transformer
from stjep_tpu_torch.parallel import distributed
from stjep_tpu_torch.parallel.mesh import make_mesh
from stjep_tpu_torch.scripts import multiproc_worker as W
from stjep_tpu_torch.train import trainer as ttrainer

from tests.data_factory import make_corpus
from tests.test_torch_mesh_train import ATOL, B, CFG, RTOL, item_for, jax_step  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JOBS = "grads:off,grads:on,steps:on,trainer:off:1,trainer:on:2,whole:on,loop:on"
LOOP_B = W.LOOP_BATCH  # 2 steps an epoch of 8 sentences
WHOLE_ROWS = W.WHOLE_ROWS  # a minibatch that does not divide over 2 ranks
LR = 1e-3


# ------------------------------------------------------------ one process


def test_init_distributed_without_a_group_is_a_no_op(monkeypatch):
    for k in distributed.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    distributed.init_distributed()
    assert not dist.is_initialized()
    assert (distributed.world_size(), distributed.rank(), distributed.is_primary()) == (1, 0, True)
    distributed.barrier("nothing to wait for")
    flat = torch.arange(3.0)
    assert distributed.all_reduce_sum(flat) is flat and flat.tolist() == [0.0, 1.0, 2.0]


def test_init_distributed_raises_when_the_rendezvous_fails(monkeypatch):
    """WORLD_SIZE asks for two processes and no rank 0 listens at the
    address: init_distributed raises, and no group is left behind (never a
    silent single-process run)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    with pytest.raises(Exception, match="timed out|refused|connect"):
        distributed.init_distributed(timeout_s=1.0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        distributed.init_distributed("localhost:1234")


@pytest.mark.parametrize("device,cards,env,world,arg,want", [
    ("cuda", 8, None, 8, None, "nccl"),  # one host, a card a rank
    ("cuda", 1, None, 2, None, "gloo"),  # two ranks share the card
    ("cuda", 8, None, 16, 8, "nccl"),  # two hosts of 8 ranks, explicit arguments
    ("cuda", 8, "8", 16, None, "nccl"),  # the same under torchrun
    ("cuda", 8, "16", 16, None, "gloo"),  # 16 ranks on a host of 8 cards
    ("cpu", 8, None, 8, None, "gloo"),  # ranks that train on the CPU
    ("cuda", 0, None, 1, None, "gloo"),  # no card
])
def test_backend_follows_the_device_and_the_ranks_a_host(monkeypatch, device, cards, env,
                                                         world, arg, want):
    """nccl only where the ranks train on CUDA and each of the host's ranks
    has a card of its own: from the device and the ranks on this host
    (local_world_size, else LOCAL_WORLD_SIZE, else the whole world), never
    from the world size alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if env is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", env)
    local = distributed.local_world(world, arg)
    assert distributed.choose_backend(device, local) == want


@pytest.mark.parametrize("world,rank,batch", [
    (1, 0, 32), (2, 0, 32), (2, 1, 32), (4, 3, 8), (2, 1, 7), (4, 2, 6)])
def test_helpers_match_jax(monkeypatch, world, rank, batch):
    """is_primary and local_batch_slice give JAX's answers, or its
    AssertionError for a batch that does not divide by the processes."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "rank", lambda: rank)
    assert distributed.is_primary() == jdist.is_primary()

    def answer(fn):
        try:
            return fn(batch)
        except AssertionError as e:
            return str(e)

    got, want = answer(distributed.local_batch_slice), answer(jdist.local_batch_slice)
    assert got == want
    assert isinstance(want, slice) == (batch % world == 0)


def test_mesh_spans_processes(monkeypatch):
    """Under two processes of two devices each the data axis is global (4)
    and process 1 holds rows 4-7 of 8; a batch that does not divide by it
    runs whole; a model axis that only the processes together could hold
    raises ValueError (JAX's global mesh would span them)."""
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    mesh = make_mesh(n_model=1, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 4, "model": 1} and len(mesh.devices) == 2
    assert mesh.process_rows(8) == slice(4, 8) and mesh.process_rows(6) is None
    assert make_mesh(n_model=2, devices=["cpu"] * 2).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="spans processes"):
        make_mesh(n_model=4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="spans processes"):
        make_mesh(n_model=2, devices=["cpu"])


@pytest.mark.parametrize("batch_dim", [0, 1, 2])
def test_draws_take_the_process_rows_of_the_whole_draw(batch_dim):
    """Under batch_rows(start, total) a draw of the process's rows equals
    those rows of the whole batch's draw from the same generator, and the
    generator moves as far (the next draw agrees too)."""
    shape = [3, 4, 5]
    whole = list(shape)
    whole[batch_dim] = 2 * shape[batch_dim]
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = transformer.uniform(g1, whole, "cpu", batch_dim=batch_dim)
    with transformer.batch_rows(shape[batch_dim], whole[batch_dim]):
        got = transformer.uniform(g2, shape, "cpu", batch_dim=batch_dim)
    assert torch.equal(got, want.narrow(batch_dim, shape[batch_dim], shape[batch_dim]))
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))


def test_head_norms_count_the_whole_minibatch():
    """head_norms on numpy and on tensors: the non-PAD targets past BOS of
    each minibatch, or with eval_with_mask False their number."""
    ids = np.array([[[2, 5, 0], [2, 0, 0]], [[2, 7, 8], [2, 9, 0]]], np.int32)
    for x in (ids, torch.from_numpy(ids)):
        n = ttrainer.head_norms(x, None)["norm_en"]
        assert np.asarray(n).tolist() == [1.0, 3.0]
        assert np.asarray(ttrainer.head_norms(x[0], x[1], False)["norm_de"]).tolist() == 4.0


# ------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, request):
    """The two ranks' outputs (meta, arrays) on JAX's init and batches 0-1
    of tests/test_torch_mesh_train.py, and the inputs they ran on. The
    ranks run while JAX compiles its step (`jax_step`, from the same init)."""
    init = jax.device_get(jinit(jax.random.PRNGKey(0), JConfig(**CFG)))
    work = tmp_path_factory.mktemp("ranks")
    cfg = ModelConfig(**CFG)
    params = params_from_numpy(init)
    items = [item_for(i, cfg) for i in range(2)]
    W.save_inputs(str(work / "inputs.npz"), params, items)
    corpus = {**make_corpus(str(work / "corpus"), n_sent=8), "max_seq_len_src": 16,
              "max_seq_len_tgt": 32}
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stjep_tpu_torch.scripts.multiproc_worker",
         "--init", f"file://{work / 'rendezvous'}", "--world", "2", "--rank", str(r),
         "--workdir", str(work), "--device", "cpu", "--cfg", json.dumps(CFG), "--batch", str(B),
         "--inputs", str(work / "inputs.npz"), "--jobs", JOBS, "--save_arrays",
         "--lr", str(LR), "--steps", "3", "--timeout", "60",
         "--corpus", json.dumps(corpus)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    jinit_, _, _ = request.getfixturevalue("jax_step")
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for (name, a), (_, b) in zip(named_leaves(init), named_leaves(jinit_), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    out = []
    for r in range(2):
        data = np.load(work / f"rank{r}.npz")
        out.append((json.loads(str(data["meta"])),
                    {k: data[k] for k in data.files if k != "meta"}))
    return out, params, items, corpus


def _one_process_grads(params, items, drop):
    cfg = ModelConfig(**CFG)
    mb = W.tensor_item(items[0])
    p = W.clone(params, "cpu")
    with W.dropout_off(drop):
        losses, grads = ttrainer.step_grads(W.job_cfg(cfg, drop), cfg.mode, p, [mb],
                                            torch.Generator().manual_seed(0), "cpu")
    return {k: float(v) for k, v in losses.items()}, [g.detach() for g in grads]


def _trainer(tmp_path, tag, rows=B):
    return ttrainer.Trainer_ASR_ST(
        expt_dir=str(tmp_path / tag), batch_size=rows, minibatch_partition=1,
        lr_warmup_steps=0, learning_rate=LR, learning_rate_init=LR, seed=0,
        device_cache=False, device="cpu")


def _one_process_trainer(tmp_path, params, items, drop, n_steps, rows=B):
    cfg = W.job_cfg(ModelConfig(**CFG), drop)
    t = _trainer(tmp_path, f"{drop}{n_steps}{rows}", rows)
    p, opt, _, _ = t.setup(W.clone(params, "cpu"), cfg)
    with W.dropout_off(drop):
        for i in range(n_steps):
            p, opt, losses = t._train_batch(cfg, p, opt,
                                            {k: v[:rows] for k, v in items[i].items()}, i + 1)
    return p, {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("drop", ["off", "on"])
def test_two_ranks_step_matches_one_process(ranks, drop):
    """Each rank's step on its 4 rows of the 8, summed over the ranks, is
    the one-process step: losses within 1e-5 relative, each gradient leaf
    within 1e-5 of its norm; both ranks report the same losses."""
    (m0, a0), (m1, _) = ranks[0]
    losses, grads = _one_process_grads(ranks[1], ranks[2], drop)
    tag = f"grads_{drop}"
    assert m0[f"{tag}_losses"] == m1[f"{tag}_losses"]
    for k, v in losses.items():
        assert abs(m0[f"{tag}_losses"][k] - v) <= 1e-5 * abs(v), (k, m0[f"{tag}_losses"], losses)
    for (name, _), g in zip(named_leaves(ranks[1]), grads, strict=True):
        got = torch.from_numpy(a0[f"{tag}/grad{name}"])
        assert float((got - g).abs().max()) <= 1e-5 * max(float(g.norm()), 1e-30), name


def test_two_ranks_step_matches_jax(ranks, jax_step):
    """Dropout off: the two ranks' Trainer step from JAX's init equals JAX's
    single-device Trainer_ASR_ST._train_batch, losses and params."""
    _, jlosses, jp = jax_step
    (m0, a0), (m1, _) = ranks[0]
    assert m0["trainer_off_1_cut"] and m1["trainer_off_1_cut"]
    for k, v in jlosses.items():
        np.testing.assert_allclose(m0["trainer_off_1_losses"][k], v, rtol=RTOL, atol=ATOL)
    for name, leaf in named_leaves(jp):
        np.testing.assert_allclose(a0[f"trainer_off_1/param{name}"], np.asarray(leaf),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_two_ranks_trainer_stays_identical_and_checkpoints_once(ranks, tmp_path):
    """After 2 Trainer steps (dropout and SpecAugment on) the ranks' params
    and Adam states are bit-equal and equal a one-process Trainer's within
    the band; the step's losses and the make_train_step steps agree across
    ranks; the checkpoint dir is one, written by rank 0 alone (its msgpack
    writes: params and optimizer state), and each rank's load of it equals
    its params and Adam state bit for bit."""
    (m0, a0), (m1, _) = ranks[0]
    tag = "trainer_on_2"
    for key in ("params_digest", "adam_digest", "losses", "path", "saved_dirs"):
        assert m0[f"{tag}_{key}"] == m1[f"{tag}_{key}"], key
    assert m0["steps_on_params_digest"] == m1["steps_on_params_digest"]
    assert m0["steps_on_step_losses"] == m1["steps_on_step_losses"]
    assert (m0[f"{tag}_writes"], m1[f"{tag}_writes"]) == (2, 0)
    assert len(m0[f"{tag}_saved_dirs"]) == 1
    assert all(m[f"{tag}_loaded_{w}_equal"] for m in (m0, m1) for w in ("params", "adam"))
    p, _ = _one_process_trainer(tmp_path, ranks[1], ranks[2], "on", 2)
    for name, leaf in named_leaves(p):
        np.testing.assert_allclose(a0[f"{tag}/param{name}"], leaf.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_two_ranks_run_a_non_dividing_minibatch_whole(ranks, tmp_path):
    """A minibatch of 3 rows over 2 ranks is not cut: each rank runs it
    whole with no sum (its losses are the one-process step's, not twice
    them), the ranks stay bit-equal, and their params equal the one-process
    Trainer's within the band."""
    (m0, a0), (m1, _) = ranks[0]
    assert not m0["whole_on_cut"] and not m1["whole_on_cut"]
    for key in ("params_digest", "adam_digest", "losses"):
        assert m0[f"whole_on_{key}"] == m1[f"whole_on_{key}"], key
    p, losses = _one_process_trainer(tmp_path, ranks[1], ranks[2], "on", 1, rows=WHOLE_ROWS)
    for k, v in losses.items():
        assert abs(m0["whole_on_losses"][k] - v) <= 1e-6 * abs(v), (k, m0["whole_on_losses"], losses)
    for name, leaf in named_leaves(p):
        np.testing.assert_allclose(a0[f"whole_on/param{name}"], leaf.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_two_ranks_train_loop_decides_alike(ranks, tmp_path):
    """Trainer.train, one epoch with dev eval and a checkpoint check every
    step: both ranks end on the same params (bit for bit) and the same
    checkpoint dirs, take the one-process run's steps and end within the
    band of its params; rank 0 alone writes scalars.jsonl, as many lines
    as the one-process run."""
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    (m0, a0), (m1, _) = ranks[0]
    corpus = ranks[3]
    for key in ("params_digest", "steps", "saved_dirs"):
        assert m0[f"loop_on_{key}"] == m1[f"loop_on_{key}"], key
    assert (m0["loop_on_writes_scalars"], m1["loop_on_writes_scalars"]) == (True, False)
    assert len(m0["loop_on_saved_dirs"]) <= 1  # keep_num 1
    cfg = ModelConfig(**{**CFG, "enc_vocab_size": corpus["vocab_src_size"],
                         "dec_vocab_size": corpus["vocab_tgt_size"],
                         "acous_dim": corpus["acous_dim"],
                         "max_seq_len_src": corpus["max_seq_len_src"],
                         "max_seq_len_tgt": corpus["max_seq_len_tgt"]})

    def dataset():
        return Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                       path_vocab_src=corpus["path_vocab_src"],
                       path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
                       acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                       max_seq_len_src=cfg.max_seq_len_src, max_seq_len_tgt=cfg.max_seq_len_tgt,
                       batch_size=LOOP_B, use_type="char", mode="ST", seed=0)

    t = ttrainer.Trainer_ASR_ST(expt_dir=str(tmp_path / "loop"), batch_size=LOOP_B,
                                checkpoint_every=1, print_every=1, lr_warmup_steps=0,
                                learning_rate=LR, learning_rate_init=LR, seed=0,
                                device_cache=False, device="cpu")
    init = init_seq2seq(cfg, torch.Generator().manual_seed(0), "cpu")
    _, final = t.train({"st": dataset()}, (cfg, init), num_epochs=1, dev_sets={"st": dataset()})
    assert m0["loop_on_steps"] == t.steps_run == 2
    with open(tmp_path / "loop" / "scalars.jsonl") as f:
        assert m0["loop_on_scalar_lines"] == sum(1 for _ in f) > 0
    ckpts = tmp_path / "loop" / "checkpoints"
    assert len(m0["loop_on_saved_dirs"]) == (len(os.listdir(ckpts)) if ckpts.is_dir() else 0)
    for name, leaf in named_leaves(final):
        np.testing.assert_allclose(a0[f"loop_on/param{name}"], leaf.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
