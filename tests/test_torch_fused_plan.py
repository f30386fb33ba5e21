"""The fused decode kernels' plan (ops/decode_flash.py `fused_tiles`,
`fused_plan`) and the C signatures of every kernel entry point, on the CPU.

The fused K5, K4, K3, K6a-c and K7c (csrc/decode_fused.cu) walk the tile table
that `fused_tiles` builds from the shapes alone, passed to them as `tiles`;
these tests hold that table in numpy: every output element of every
product phase is written by exactly one tile, each split covers its slice
of the contraction once, the dynamic shared memory fits a Hopper block, the
workspace holds every phase's partials, and nothing depends on how many
blocks the card keeps resident. K5's and K4's tables and plans are held
byte-equal to the ones they had before the shard steps shared their code;
the shard steps K6a-c at a shard of n = 1, 2, 4 and 8 (attention width
D / n, hidden width FF / n). K3's chain plan is K4's with a row phase in
place of the embedding and no select; K7c's shard head at n = 1, 2, 4;
K7's head over the whole vocabulary (`step="full_head"`), its top-K by
column slices and the merge of a row's slices, whose arithmetic a numpy
model of the kernel's slice and merge phases holds against the whole
row's log-softmax top-K, the lowest id first among ties.
The second half parses every
`extern "C"` entry of csrc/*.cu and holds its parameter kinds against
kernels._SIGS, the argument types ctypes passes.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.ops.decode_flash import (
    FUSED_BM,
    FUSED_BN,
    FUSED_KC,
    FUSED_PRODUCTS,
    FUSED_THREADS,
    HEAD_CAND,
    HEAD_SLICE,
    fused_plan,
    fused_tiles,
)

SMEM_MAX = 232448  # the shared memory an H100 block may opt in to
# the dynamic shared memory the shard steps' plans are given to stage
# attention items in (on the card, step_smem_max: the opt-in maximum less
# the kernel's static shared memory)
STEP_SMEM = SMEM_MAX - 1024

# (BK, D, FF, heads, Lpad, Lk, V): the flagship (bench.py: B=16 x beam 5,
# D 512, FF 1024, 8 heads, 160 cache rows, 96 memory rows, 200 ids), the
# card tests' shapes, and widths off every tile
SHAPES = {
    "flagship": (80, 512, 1024, 8, 160, 96, 200),
    "flagship_B64": (320, 512, 1024, 8, 160, 96, 200),
    "B1": (5, 512, 1024, 8, 160, 96, 200),
    "tests": (9, 128, 256, 4, 16, 45, 40),
    "ragged": (7, 96, 200, 3, 48, 45, 37),
}


def _table(BK, D, FF, V, Dq=None, step=None):
    """{kind: [(job, split, first row, first column)]} from the table the
    kernels read, checking its header: one offset per kind, then the end."""
    t = fused_tiles(BK, D, FF, V, Dq, step).numpy()
    n = len(FUSED_PRODUCTS)
    off, rows = t[:n + 1], t[n + 1:].reshape(-1, 4)
    assert off[0] == 0 and off[-1] == len(rows) and (np.diff(off) >= 0).all()
    return {k: rows[off[i]:off[i + 1]] for i, k in enumerate(FUSED_PRODUCTS)}


@pytest.mark.parametrize("beam", [False, True], ids=["K5", "K4"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_every_output_element_written_once(shape, beam):
    """Per product kind of the table, per job: every element of the job's
    [splits, M, N] partials written by exactly one tile, each split summing
    its KC slice of the contraction once; a product phase's work items are
    its tiles."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES[shape]
    V = V if beam else 0
    plan = fused_plan(BK, D, FF, nh, Lpad, Lk, beam=beam, nl=2, V=V, K=1)
    table = _table(BK, D, FF, V)
    assert ("head" in plan["products"]) == beam == (len(table["head"]) > 0)
    _each_output_once(plan, table)


def _each_output_once(plan, table):
    """Every element of each job's partials written by one tile of its
    kind's run, each split its KC slice once; kinds the plan has no jobs
    for have no tiles."""
    items = dict(plan["phases"])
    for name in FUSED_PRODUCTS:
        if name not in plan["products"]:
            assert len(table[name]) == 0, name
    for name, jobs in plan["products"].items():
        rows = table[name]
        assert set(rows[:, 0]) == set(range(len(jobs))), name
        for j, (M, N, Kd) in enumerate(jobs):
            S = -(-Kd // FUSED_KC)
            out = np.zeros((S, M, N), np.int64)
            for _, s, r0, c0 in rows[rows[:, 0] == j]:
                assert 0 <= s < S and r0 % FUSED_BM == 0 and c0 % FUSED_BN == 0
                out[s, r0:r0 + FUSED_BM, c0:c0 + FUSED_BN] += 1
            assert (out == 1).all(), (name, j, M, N, Kd)
            depth = np.zeros(Kd, np.int64)
            for s in range(S):
                depth[s * FUSED_KC:(s + 1) * FUSED_KC] += 1
            assert (depth == 1).all(), name
        assert items[name] == len(rows)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_shared_memory_and_workspace_fit(shape, quant):
    """The dynamic shared memory fits a block; the workspace holds the five
    [BK, D] activations, PA (q/k/v, w1 or the head partials) and PB (fc,
    cq, co or w2 partials), the logits and the head's top-K."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES[shape]
    K = 5 if BK % 5 == 0 else 1
    for beam in (False, True):
        plan = fused_plan(BK, D, FF, nh, Lpad, Lk, quant, beam, nl=6, V=V if beam else 0, K=K)
        assert 0 < plan["smem"] <= SMEM_MAX
        parts = {n: sum(-(-Kd // FUSED_KC) * M * N for M, N, Kd in jobs)
                 for n, jobs in plan["products"].items()}
        pa = max(parts["qkv"], parts["w1"], parts.get("head", 0))
        pb = max(parts["fc"], parts["cq"], parts["co"], parts["w2"])
        Vb = V if beam else 0
        assert plan["ws_floats"] == 5 * BK * D + pa + pb + BK * Vb + 2 * BK * K


@pytest.mark.parametrize("beam", [False, True], ids=["K5", "K4"])
def test_phases_and_barriers(beam):
    """K5: a LayerNorm row phase then the layer's 11 phases, 11 barriers;
    K4: the embedding, nl layers, the head's product, its top-K and the
    select, 3 + 11 nl barriers. Attention phases have a work item per
    (row, head), row phases one per row."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES["flagship"]
    plan = fused_plan(BK, D, FF, nh, Lpad, Lk, beam=beam, nl=6, V=V, K=5)
    names = [n for n, _ in plan["phases"]]
    assert plan["barriers"] == (3 + 11 * 6 if beam else 11) == len(names) - 1
    assert names.count("self") == names.count("cross") == (6 if beam else 1)
    items = dict(plan["phases"])
    assert items["self"] == items["cross"] == BK * nh and items["row"] == BK
    if beam:
        assert names[0] == "embed" and names[-3:] == ["head", "topk", "select"]
        assert items["select"] == BK // 5 and items["topk"] == BK


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_tiling_does_not_change_with_the_grid(sms, per_sm):
    """Neither the plan nor the tile table takes an SM count, and the
    kernel's block-strided walk over a phase's work items gives every item
    to exactly one block at any grid size."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES["flagship"]
    plan = fused_plan(BK, D, FF, nh, Lpad, Lk, beam=True, nl=2, V=V, K=5)
    assert fused_plan.__wrapped__(BK, D, FF, nh, Lpad, Lk, beam=True, nl=2, V=V, K=5) == plan
    assert torch.equal(fused_tiles(BK, D, FF, V), fused_tiles(BK, D, FF, V))
    grid = sms * per_sm
    for name, n in plan["phases"]:
        seen = np.zeros(n, np.int64)
        for b in range(grid):
            seen[b:n:grid] += 1
        assert (seen == 1).all(), name


# K5's and K4's plans and tile tables before the shard steps shared their
# code: sha256 of repr(sorted(plan.items())) then the table's bytes, first
# 16 hex digits, per (shape, K5/K4, f32/int8) of SHAPES (nl 6 for K4)
PARENT_DIGESTS = {
    ("flagship", "K5", "f32"): "cb5c7e0dc4141fb4", ("flagship", "K5", "int8"): "c367302a8c8c832d",
    ("flagship", "K4", "f32"): "45d7fcde5a6c82e2", ("flagship", "K4", "int8"): "45d7fcde5a6c82e2",
    ("flagship_B64", "K5", "f32"): "8807481c9f8d8786",
    ("flagship_B64", "K5", "int8"): "a35b133b0afa5fb5",
    ("flagship_B64", "K4", "f32"): "5ad420279ea5672b",
    ("flagship_B64", "K4", "int8"): "5ad420279ea5672b",
    ("B1", "K5", "f32"): "1600f013be994adc", ("B1", "K5", "int8"): "536a0d3bd315696c",
    ("B1", "K4", "f32"): "c0bebc31a65eeb51", ("B1", "K4", "int8"): "c0bebc31a65eeb51",
    ("tests", "K5", "f32"): "1f1855fc1601d2da", ("tests", "K5", "int8"): "e54ac88c9c5afe96",
    ("tests", "K4", "f32"): "ff61cb51323ec38f", ("tests", "K4", "int8"): "ff61cb51323ec38f",
    ("ragged", "K5", "f32"): "5ab50b9ec716071e", ("ragged", "K5", "int8"): "d9684735bd284e0b",
    ("ragged", "K4", "f32"): "84330a0d63c2d1df", ("ragged", "K4", "int8"): "84330a0d63c2d1df",
}


@pytest.mark.parametrize("key", sorted(PARENT_DIGESTS), ids="-".join)
def test_k5_and_k4_plans_are_the_parents(key):
    """K5 and K4 are the case Dq = D with the whole FF of the generalised
    plan: their tile tables, phases, shared memory and workspace are byte
    for byte what they were."""
    shape, step, quant = key
    BK, D, FF, nh, Lpad, Lk, V = SHAPES[shape]
    beam = step == "K4"
    V = V if beam else 0
    plan = fused_plan.__wrapped__(BK, D, FF, nh, Lpad, Lk, quant == "int8", beam,
                                  6 if beam else 1, V, 5 if BK % 5 == 0 else 1)
    blob = repr(sorted(plan.items())).encode() + fused_tiles(BK, D, FF, V).numpy().tobytes()
    assert hashlib.sha256(blob).hexdigest()[:16] == PARENT_DIGESTS[key]
    assert torch.equal(fused_tiles(BK, D, FF, V), fused_tiles(BK, D, FF, V, Dq=D))


# (BK, D, FF, heads, Lpad, Lk) of the shard steps: the flagship beam (B=16
# x 5), B=1 and B=64, and widths off every tile (a shard of 8 at d = 32 is
# one head of 32 columns, FF / 8 = 75)
SHARD_SHAPES = {
    "flagship": (80, 512, 1024, 8, 160, 96),
    "B1": (5, 512, 1024, 8, 160, 96),
    "flagship_B64": (320, 512, 1024, 8, 160, 96),
    "ragged": (13, 256, 600, 8, 48, 45),
}
SHARDS = [1, 2, 4, 8]
STEPS = ["self", "cross", "ffn"]
STEP_IDS = ["K6a", "K6b", "K6c"]


def _step(step, shape, n):
    """(plan, table) of K6a ("self"), K6b ("cross") or K6c ("ffn") at one
    shard of n."""
    BK, D, FF, nh, Lpad, Lk = SHARD_SHAPES[shape]
    K = 5 if BK % 5 == 0 else 1
    if step == "ffn":
        return (fused_plan(BK, D, FF // n, 1, 0, 0, step="ffn"),
                _table(BK, D, FF // n, 0, step="ffn"))
    return (fused_plan(BK, D, 0, nh // n, Lpad, Lk, K=K, Dq=D // n, step=step,
                       smem_max=STEP_SMEM),
            _table(BK, D, 0, 0, D // n, step))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("step", STEPS, ids=STEP_IDS)
@pytest.mark.parametrize("shape", list(SHARD_SHAPES), ids=list(SHARD_SHAPES))
def test_shard_step_writes_every_output_element_once(shape, step, n):
    """K6a's q, k, v [D, D/n] and fc [D/n, D] products, K6b's cq [D, D/n]
    and co [D/n, D], K6c's w1 [D, FF/n] and w2 [FF/n, D]: every partial
    element written by one tile, each split its slice once, and no tile of
    a kind the step does not run."""
    plan, table = _step(step, shape, n)
    BK, D, FF, _, _, _ = SHARD_SHAPES[shape]
    Dq = D // n
    want = {"self": {"qkv": [(BK, Dq, D)] * 3, "fc": [(BK, D, Dq)]},
            "cross": {"cq": [(BK, Dq, D)], "co": [(BK, D, Dq)]},
            "ffn": {"w1": [(BK, FF // n, D)], "w2": [(BK, D, FF // n)]}}[step]
    assert plan["products"] == want
    _each_output_once(plan, table)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("step", STEPS, ids=STEP_IDS)
@pytest.mark.parametrize("shape", list(SHARD_SHAPES), ids=list(SHARD_SHAPES))
def test_shard_step_shared_memory_and_workspace_fit(shape, step, n):
    """Two f32 product stages and, for K6a and K6b, att_warps attention
    items of d + 3 L floats (L the cache's or the memory's rows) fit the
    block's shared memory; the workspace holds the five [BK, D]
    activations (XN and the [BK, D/n] context among them), PA (K6a's q, k,
    v or K6c's w1 partials; 3 q-sized partials in any case) and PB (the
    second product's partials, or K6b's cross query's if larger), and the
    2 BK K floats of the head's top-K the layout keeps."""
    plan, _ = _step(step, shape, n)
    BK, D, FF, nh, Lpad, Lk = SHARD_SHAPES[shape]
    prod = 2 * (FUSED_KC * FUSED_BN * 4 + FUSED_KC * FUSED_BM * 4)
    assert prod <= plan["smem"] <= SMEM_MAX
    part = lambda M, N, Kd: -(-Kd // FUSED_KC) * M * N
    first, second = (part(*jobs[0]) for jobs in plan["products"].values())
    if step == "ffn":
        K, pa, pb = 1, first, second
        assert plan["att_warps"] == 0 and plan["smem"] == prod
    else:
        K = 5 if BK % 5 == 0 else 1
        pa, pb = 3 * part(BK, D // n, D), max(second, part(BK, D // n, D))
        per = (D // nh + 3 * (Lpad if step == "self" else Lk)) * 4
        assert plan["att_warps"] == 8 and 8 * per <= plan["smem"] <= max(prod, 8 * per)
    assert plan["ws_floats"] == 5 * BK * D + pa + pb + 2 * BK * K


@pytest.mark.parametrize("step", STEPS, ids=STEP_IDS)
def test_shard_step_phases_and_barriers(step):
    """K6a: row (LayerNorm), qkv, self, fc, row: 4 barriers; K6b: row, cq,
    cross, co, row: 4; K6c: row, w1, w2, row: 3. A launch asks for as many
    blocks as its largest phase has items, an attention phase's counted
    att_warps a block: at the flagship beam's shard of 4, K6a's qkv phase
    has 120 tiles, K6b's row phases 80 rows (cq 40 tiles, co 40), K6c's
    products 80 tiles."""
    plan, _ = _step(step, "flagship", 4)
    names = [k for k, _ in plan["phases"]]
    assert names == {"self": ["row", "qkv", "self", "fc", "row"],
                     "cross": ["row", "cq", "cross", "co", "row"],
                     "ffn": ["row", "w1", "w2", "row"]}[step]
    assert plan["barriers"] == len(names) - 1 == (3 if step == "ffn" else 4)
    items = dict(plan["phases"])
    assert items["row"] == 80
    if step == "self":
        assert items["self"] == 80 * 2 and (items["qkv"], items["fc"]) == (120, 40)
    elif step == "cross":
        assert items["cross"] == 80 * 2 and (items["cq"], items["co"]) == (40, 40)
    else:
        assert items["w1"] == items["w2"] == 80
    assert plan["blocks"] == {"self": 120, "cross": 80, "ffn": 80}[step]


@pytest.mark.parametrize("grid", [1, 7, 80, 120, 132, 264, 396])
@pytest.mark.parametrize("step", STEPS, ids=STEP_IDS)
def test_shard_step_tiling_does_not_change_with_the_grid(step, grid):
    """The shard steps' plan and table take no block count, and the
    block-strided walk gives every item of every phase to one block (an
    attention phase's to one warp) at any grid, the plan's own included."""
    plan, table = _step(step, "flagship", 4)
    again = _step(step, "flagship", 4)
    assert again[0] == plan and all((again[1][k] == table[k]).all() for k in table)
    for name, n in plan["phases"]:
        per = plan["att_warps"] if name in ("self", "cross") else 1
        seen = np.zeros(n, np.int64)
        for b in range(grid):
            for w in range(per):
                seen[b * per + w:n:grid * per] += 1
        assert (seen == 1).all(), name


@pytest.mark.parametrize("step", ["self", "cross"], ids=["K6a", "K6b"])
def test_attention_steps_stage_long_rows_on_fewer_warps(step):
    """At d = 64 eight warps stage ~900 cache (K6a) or memory (K6b) rows
    past the product stages; 4000 rows run on 4 warps a block, and past
    ~19 000 rows not one warp's staging fits: the plan refuses them."""
    rows = lambda L: (L, 0) if step == "self" else (0, L)
    plan = fused_plan(10, 512, 0, 2, *rows(4000), K=5, Dq=128, step=step, smem_max=STEP_SMEM)
    per = (64 + 3 * 4000) * 4
    assert plan["att_warps"] == STEP_SMEM // per == 4
    assert plan["smem"] == 4 * per <= SMEM_MAX
    first = 3 * 8 if step == "self" else 8  # the q/k/v or cross query tiles
    assert plan["blocks"] == max(10, first, -(-20 // 4), 2 * 1 * 4)
    with pytest.raises(ValueError, match="cache rows" if step == "self" else "memory rows"):
        fused_plan(10, 512, 0, 2, *rows(20000), K=5, Dq=128, step=step, smem_max=STEP_SMEM)


@pytest.mark.parametrize("smem_max", [STEP_SMEM, 98 * 1024], ids=["H100", "98KB"])
@pytest.mark.parametrize("L", [600, 4000])
@pytest.mark.parametrize("step", ["self", "cross"], ids=["K6a", "K6b"])
def test_attention_steps_stage_within_the_cards_limit(step, L, smem_max):
    """K6a and K6b stage as many attention items a block as the card's
    limit (smem_max, asked of the card on a GPU) holds, at most 8, and ask
    for no more shared memory than that or the two product stages."""
    rows = (L, 0) if step == "self" else (0, L)
    plan = fused_plan(10, 512, 0, 2, *rows, K=5, Dq=128, step=step, smem_max=smem_max)
    per = (64 + 3 * L) * 4
    prod = 2 * (FUSED_KC * FUSED_BN * 4 + FUSED_KC * FUSED_BM * 4)
    assert plan["att_warps"] == min(8, smem_max // per) >= 1
    assert plan["smem"] == max(prod, plan["att_warps"] * per) <= max(prod, smem_max)


@pytest.mark.parametrize("step", ["self", "cross"], ids=["K6a", "K6b"])
def test_attention_step_plans_need_the_cards_limit(step):
    """A K6a or K6b plan asked without smem_max is refused, not guessed;
    K6c stages no attention and takes none."""
    with pytest.raises(ValueError, match="smem_max"):
        fused_plan(10, 512, 0, 2, 96, 96, K=5, Dq=128, step=step)
    assert fused_plan(10, 512, 256, 1, 0, 0, step="ffn")["att_warps"] == 0


# ---------------------------------------------------------------------------
# K3 (decode_chain_fused): K4's plan less the embedding and the select
# ---------------------------------------------------------------------------


def _chain(shape, nl=2, quant=False, K=None):
    BK, D, FF, nh, Lpad, Lk, V = SHAPES[shape]
    K = K or (5 if BK % 5 == 0 else 1)
    return fused_plan(BK, D, FF, nh, Lpad, Lk, quant, nl=nl, V=V, K=K, chain=True)


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_chain_writes_every_output_element_once(shape):
    """K3's products (every layer's and the head over V ids) against the
    table K4 walks at the same shapes: every partial element written by
    one tile, each split its KC slice once."""
    BK, D, FF, _, _, _, V = SHAPES[shape]
    plan = _chain(shape)
    assert set(plan["products"]) == set(FUSED_PRODUCTS)
    assert plan["products"]["head"] == [(BK, V, D)]
    _each_output_once(plan, _table(BK, D, FF, V))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_chain_shared_memory_and_workspace_fit(shape, quant):
    """Two f32 product stages (the head's weights are f32 in every
    variant) or eight attention items fit a block; the workspace is K4's
    layout with the head: five [BK, D] activations, PA (q/k/v, w1 or the
    head's partials), PB, the [BK, V] logits and 2 BK K floats."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES[shape]
    K = 5 if BK % 5 == 0 else 1
    plan = _chain(shape, 6, quant)
    prod = 2 * (FUSED_KC * FUSED_BN * 4 + FUSED_KC * FUSED_BM * 4)
    assert plan["smem"] == max(prod, 8 * (D // nh + 3 * max(Lpad, Lk)) * 4) <= SMEM_MAX
    parts = {n: sum(-(-Kd // FUSED_KC) * M * N for M, N, Kd in jobs)
             for n, jobs in plan["products"].items()}
    pa = max(parts["qkv"], parts["w1"], parts["head"])
    pb = max(parts["fc"], parts["cq"], parts["co"], parts["w2"])
    assert plan["ws_floats"] == 5 * BK * D + pa + pb + BK * V + 2 * BK * K
    k4 = fused_plan(BK, D, FF, nh, Lpad, Lk, quant, True, 6, V, K)
    assert (plan["smem"], plan["ws_floats"]) == (k4["smem"], k4["ws_floats"])


@pytest.mark.parametrize("nl", [1, 2, 6])
def test_chain_phases_and_barriers(nl):
    """K3: a row phase (its input and LN1 of layer 0), nl layers of 11
    phases, the head's product and the top-K: K4's phases less the
    embedding and the select, 2 + 11 nl barriers."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES["flagship"]
    plan = _chain("flagship", nl)
    k4 = fused_plan(BK, D, FF, nh, Lpad, Lk, beam=True, nl=nl, V=V, K=5)
    assert plan["phases"] == [("row", BK)] + k4["phases"][1:-1]
    assert k4["phases"][0] == ("embed", BK) and k4["phases"][-1] == ("select", BK // 5)
    assert plan["barriers"] == 2 + 11 * nl == len(plan["phases"]) - 1
    assert plan["phases"][-2:] == [("head", 8 * 5 * 2), ("topk", BK)]


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_chain_tiling_does_not_change_with_the_grid(sms, per_sm):
    """K3's plan and table take no SM count, and the block-strided walk
    gives every item of every phase to one block at any grid size."""
    BK, D, FF, nh, Lpad, Lk, V = SHAPES["flagship"]
    plan = _chain("flagship")
    assert fused_plan.__wrapped__(BK, D, FF, nh, Lpad, Lk, nl=2, V=V, K=5, chain=True) == plan
    grid = sms * per_sm
    for name, n in plan["phases"]:
        seen = np.zeros(n, np.int64)
        for b in range(grid):
            seen[b:n:grid] += 1
        assert (seen == 1).all(), name


# ---------------------------------------------------------------------------
# K7c (head_partial_fused): one vocabulary shard of the head
# ---------------------------------------------------------------------------

# (BK, D, V): the flagship beam, B=1, B=64, an off-tile width and a
# 30 000-word vocabulary
HEAD_SHAPES = {
    "flagship": (80, 512, 200),
    "B1": (5, 512, 200),
    "flagship_B64": (320, 512, 200),
    "ragged": (13, 96, 600),
    "V30000": (80, 512, 30000),
}
HEAD_SHARDS = [1, 2, 4]


def _head(shape, n):
    BK, D, V = HEAD_SHAPES[shape]
    return fused_plan(BK, D, 0, 1, 0, 0, V=V // n, step="head"), _table(BK, D, 0, V // n,
                                                                        step="head")


@pytest.mark.parametrize("n", HEAD_SHARDS)
@pytest.mark.parametrize("shape", list(HEAD_SHAPES), ids=list(HEAD_SHAPES))
def test_head_step_writes_every_output_element_once(shape, n):
    """K7c's one product, x_n [BK, D] @ the shard's [D, V/n]: every partial
    element written by one tile, each split its slice once, and no tile of
    another kind."""
    BK, D, V = HEAD_SHAPES[shape]
    plan, table = _head(shape, n)
    assert plan["products"] == {"head": [(BK, V // n, D)]}
    _each_output_once(plan, table)


@pytest.mark.parametrize("n", HEAD_SHARDS)
@pytest.mark.parametrize("shape", list(HEAD_SHAPES), ids=list(HEAD_SHAPES))
def test_head_step_shared_memory_and_workspace_fit(shape, n):
    """Two f32 product stages and nothing else in shared memory; the
    workspace holds the five [BK, D] activations (XN among them), the head's
    partials in PA, the [BK, V/n] logits and the 2 BK floats of a top-K of
    one the layout keeps (PB is empty)."""
    BK, D, V = HEAD_SHAPES[shape]
    plan, _ = _head(shape, n)
    assert plan["smem"] == 2 * (FUSED_KC * FUSED_BN * 4 + FUSED_KC * FUSED_BM * 4) <= SMEM_MAX
    assert plan["att_warps"] == 0
    pa = -(-D // FUSED_KC) * BK * (V // n)
    assert plan["ws_floats"] == 5 * BK * D + pa + BK * (V // n) + 2 * BK


@pytest.mark.parametrize("n", HEAD_SHARDS)
def test_head_step_phases_and_barriers(n):
    """K7c: row (LayerNorm), head, topk: 2 barriers; the launch asks for
    as many blocks as its largest phase has items (at the flagship's shard
    of 4, the 80 rows; 40 head tiles)."""
    plan, _ = _head("flagship", n)
    V = 200 // n
    tiles = 8 * 5 * -(-V // FUSED_BN)
    assert plan["phases"] == [("row", 80), ("head", tiles), ("topk", 80)]
    assert plan["barriers"] == 2
    assert plan["blocks"] == max(80, tiles) == {1: 80, 2: 80, 4: 80}[n]
    assert _head("V30000", n)[0]["blocks"] == 8 * 5 * -(-30000 // n // FUSED_BN)


@pytest.mark.parametrize("grid", [1, 7, 80, 132, 264, 396])
@pytest.mark.parametrize("n", HEAD_SHARDS)
def test_head_step_tiling_does_not_change_with_the_grid(n, grid):
    """K7c's plan and table take no block count, and the block-strided walk
    gives every item of every phase to one block at any grid."""
    plan, table = _head("flagship", n)
    again = _head("flagship", n)
    assert again[0] == plan and all((again[1][k] == table[k]).all() for k in table)
    for name, items in plan["phases"]:
        seen = np.zeros(items, np.int64)
        for b in range(grid):
            seen[b:items:grid] += 1
        assert (seen == 1).all(), name


# ---------------------------------------------------------------------------
# K7 (head_fused): the decode head over the whole vocabulary
# ---------------------------------------------------------------------------

# (BK, D, V): the universal beam (B=16 x beam 5), greedy dev eval (B=16,
# top-1), B=64, the card tests' 128-wide head, one slice exactly, one id
# past it, and word-level vocabularies of 13 000 and 30 000 ids
FULL_SHAPES = {
    "beam": (80, 512, 200),
    "dev_eval": (16, 512, 200),
    "B64": (320, 512, 200),
    "tests": (7, 128, 40),
    "one_slice": (16, 512, HEAD_SLICE),
    "two_slices": (16, 512, HEAD_SLICE + 1),
    "V13000": (16, 128, 13000),
    "V30000": (80, 512, 30000),
}


def _full(shape):
    BK, D, V = FULL_SHAPES[shape]
    return (fused_plan(BK, D, 0, 1, 0, 0, V=V, step="full_head"),
            _table(BK, D, 0, V, step="full_head"))


@pytest.mark.parametrize("shape", list(FULL_SHAPES), ids=list(FULL_SHAPES))
def test_full_head_writes_every_output_element_once(shape):
    """K7's one product, x_n [BK, D] @ [D, V]: every partial element
    written by one tile, each split its slice once; the table is K7c's at
    one shard."""
    BK, D, V = FULL_SHAPES[shape]
    plan, table = _full(shape)
    assert plan["products"] == {"head": [(BK, V, D)]}
    _each_output_once(plan, table)
    k7c = _table(BK, D, 0, V, step="head")
    assert all((k7c[k] == table[k]).all() for k in table)


@pytest.mark.parametrize("shape", list(FULL_SHAPES), ids=list(FULL_SHAPES))
def test_full_head_shared_memory_and_workspace_fit(shape):
    """Two f32 product stages in shared memory; K7c's workspace at one
    shard, whose [BK, V] logit region holds the slices' records (HEAD_CAND
    floats a row and slice) wherever a row has more than one slice: the
    logits themselves are never stored."""
    BK, D, V = FULL_SHAPES[shape]
    plan, _ = _full(shape)
    assert plan["smem"] == 2 * (FUSED_KC * FUSED_BN * 4 + FUSED_KC * FUSED_BM * 4) <= SMEM_MAX
    pa = -(-D // FUSED_KC) * BK * V
    assert plan["ws_floats"] == 5 * BK * D + pa + BK * V + 2 * BK
    assert plan["ws_floats"] == fused_plan(BK, D, 0, 1, 0, 0, V=V, step="head")["ws_floats"]
    if plan["slices"] > 1:
        assert BK * plan["slices"] * HEAD_CAND <= BK * V


@pytest.mark.parametrize("shape", list(FULL_SHAPES), ids=list(FULL_SHAPES))
def test_full_head_phases_and_barriers(shape):
    """K7: row (LayerNorm), head, slice (a row's top-K by column slices of
    HEAD_SLICE ids, a (row, slice) an item), and past one slice a row the
    merge: 2 or 3 barriers; the launch asks for as many blocks as its
    largest phase has items."""
    BK, D, V = FULL_SHAPES[shape]
    plan, table = _full(shape)
    n = -(-V // HEAD_SLICE)
    phases = [("row", BK), ("head", len(table["head"])), ("slice", BK * n)]
    assert plan["slices"] == n
    assert plan["phases"] == phases + ([("merge", BK)] if n > 1 else [])
    assert plan["barriers"] == (2 if n == 1 else 3)
    assert plan["blocks"] == max(items for _, items in plan["phases"])


def test_full_head_main_path_shapes():
    """At the model's 200 ids: the universal beam's 80 rows are 8 splits x
    5 row tiles x 2 column tiles = 80 head tiles and 80 top-K rows on 80
    blocks; dev eval's 16 rows 16 tiles and 16 rows on 16 blocks; 2
    barriers each. At 30 000 ids: 15 slices a row, 3 barriers, and 9400
    head tiles at 80 rows."""
    beam, dev_eval, big = _full("beam")[0], _full("dev_eval")[0], _full("V30000")[0]
    assert beam["phases"] == [("row", 80), ("head", 80), ("slice", 80)]
    assert (beam["blocks"], beam["barriers"]) == (80, 2)
    assert dev_eval["phases"] == [("row", 16), ("head", 16), ("slice", 16)]
    assert (dev_eval["blocks"], dev_eval["barriers"]) == (16, 2)
    assert big["slices"] == 15 and big["barriers"] == 3
    assert big["phases"][1:] == [("head", 9400), ("slice", 1200), ("merge", 80)]


@pytest.mark.parametrize("grid", [1, 7, 16, 80, 132, 264, 396])
@pytest.mark.parametrize("shape", ["beam", "dev_eval", "V30000"])
def test_full_head_tiling_does_not_change_with_the_grid(shape, grid):
    """K7's plan and table take no block count, and the block-strided walk
    gives every item of every phase to one block at any grid."""
    plan, table = _full(shape)
    again = _full(shape)
    assert again[0] == plan and all((again[1][k] == table[k]).all() for k in table)
    for name, items in plan["phases"]:
        seen = np.zeros(items, np.int64)
        for b in range(grid):
            seen[b:items:grid] += 1
        assert (seen == 1).all(), name


def test_full_head_constants_mirror_the_source():
    """HEAD_SLICE and HEAD_CAND are decode_chain.cu's SLICE (SLICE_COLS
    registers of THREADS threads) and CAND (2 MAX_BEAM + 2); MAX_SLICES
    keeps the merge's nS * topk candidates within a 32-bit taken mask a
    thread. K7's kernel takes K7c's argument struct (mx and se null)."""
    src = (CSRC / "decode_chain.cu").read_text()
    beam = int(re.search(r"constexpr int MAX_BEAM = (\d+);",
                         (CSRC / "head_select.cuh").read_text()).group(1))
    cols = int(re.search(r"constexpr int SLICE_COLS = (\d+);", src).group(1))
    assert "constexpr int SLICE = SLICE_COLS * THREADS;" in src
    assert "constexpr int CAND = 2 * MAX_BEAM + 2;" in src
    assert "constexpr int MAX_SLICES = 32 * THREADS / MAX_BEAM;" in src
    assert "head_full_kernel(const HeadArgs a)" in src and "struct HeadArgs" in src
    assert src.count("struct ") == 2  # ChainArgs, HeadArgs
    assert HEAD_SLICE == cols * FUSED_THREADS
    assert HEAD_CAND == 2 * beam + 2
    assert cols <= 32  # a slice's live ids fit a thread's 32-bit mask


def _slice_cols(s, V):
    """The ids of column slice s, thread by thread (thread t's register j
    holds id s * HEAD_SLICE + j * FUSED_THREADS + t)."""
    cols = s * HEAD_SLICE + np.arange(HEAD_SLICE).reshape(-1, FUSED_THREADS)
    return cols[cols < V] if cols.max() >= V else cols.ravel()


def _argmax_lowest(v, ids):
    """decode_chain.cu's arg-max pass: the largest value, the lowest id
    among equals (common.cuh `better`)."""
    best = np.flatnonzero(v == v.max())
    return best[np.argmin(ids[best])]


def _k7_model(logits, topk):
    """The kernel's slice and merge phases on one row in float64: each
    slice's max, sum-exp at that max and raw top-K; one slice finishes the
    row itself, else the merge takes lse from the slices in slice order and
    the top-K of their candidates."""
    V = logits.shape[0]
    n = -(-V // HEAD_SLICE)
    recs = []
    for s in range(n):
        cols = np.sort(_slice_cols(s, V).ravel())
        v = logits[cols]
        mx = v.max()
        se = np.exp(v - mx).sum()
        live = np.ones(len(cols), bool)
        vals, ids = [], []
        for _ in range(min(topk, len(cols))):
            i = _argmax_lowest(np.where(live, v, -np.inf), np.where(live, cols, 1 << 31))
            vals.append(v[i])
            ids.append(cols[i])
            live[i] = False
        recs.append((vals, ids, mx, se))
    mx = max(r[2] for r in recs)
    se = sum(r[3] * np.exp(r[2] - mx) for r in recs)
    lse = mx + np.log(se)
    cv = np.array([v for r in recs for v in r[0]])
    ci = np.array([i for r in recs for i in r[1]])
    live = np.ones(len(cv), bool)
    out_v, out_i = [], []
    for _ in range(topk):
        i = _argmax_lowest(np.where(live, cv, -np.inf), np.where(live, ci, 1 << 31))
        out_v.append(cv[i] - lse)
        out_i.append(ci[i])
        live[i] = False
    return np.array(out_v), np.array(out_i), lse


# (V, topk): K7 takes a top-K of at most V
MERGE_CASES = [(V, k) for V in (1, 40, 200, HEAD_SLICE, HEAD_SLICE + 1, 13000, 30000)
               for k in (1, 5, 16) if k <= V]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("V,topk", MERGE_CASES)
def test_full_head_slices_merge_to_the_rows_top_k(V, topk, ties):
    """The slices cover each id once, in id order slice by slice, so the
    merge in slice order with the lowest id winning ties gives the whole
    row's log-softmax top-K in jax.lax.top_k's order, and lse the row's
    log-sum-exp; with every value repeated 8 ids later (exact ties) the
    ids step by 8 from the lowest copy, across slices too."""
    rng = np.random.RandomState(V + topk)
    logits = rng.randn(V) * 3
    if ties:
        logits = logits[np.arange(V) % 8]
    n = -(-V // HEAD_SLICE)
    every = np.concatenate([_slice_cols(s, V).ravel() for s in range(n)])
    assert np.array_equal(np.sort(every), np.arange(V))
    for s in range(n - 1):
        assert _slice_cols(s, V).max() < _slice_cols(s + 1, V).min()
    sc, ids, lse = _k7_model(logits, topk)
    order = np.lexsort((np.arange(V), -logits))[:topk]
    assert np.array_equal(ids, order)
    full_lse = logits.max() + np.log(np.exp(logits - logits.max()).sum())
    assert abs(lse - full_lse) < 1e-9
    assert np.allclose(sc, logits[order] - full_lse, atol=1e-9)
    if ties and topk > 1 and V >= 8 * topk:
        assert (np.diff(ids) == 8).all()


# ---------------------------------------------------------------------------
# the C entry points against the ctypes signatures
# ---------------------------------------------------------------------------

CSRC = Path(kernels.__file__).with_name("csrc")


def _entries():
    """{name: parameter kinds} of every `extern "C"` function in csrc/*.cu:
    p (pointer), i (int), f (float), s (the stream)."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append("p")
                elif p.startswith("cudaStream_t"):
                    kinds.append("s")
                elif p.startswith("float"):
                    kinds.append("f")
                elif p.startswith("int"):
                    kinds.append("i")
                else:
                    raise AssertionError(f"{src.name} {name}: parameter {p!r}")
            out[name] = "".join(kinds)
    return out


def test_every_entry_point_has_a_signature():
    assert set(_entries()) == set(kernels._SIGS)


def test_shard_step_entries_are_declared():
    """The fused K6a-c entries, with their pointers first and their ints
    after, as ops/decode_flash.py passes them."""
    entries = _entries()
    assert entries["self_attn_step_fused"] == "p" * 14 + "i" * 12 + "s"
    assert entries["cross_attn_step_fused"] == "p" * 11 + "i" * 11 + "s"
    assert entries["ffn_step_fused"] == "p" * 10 + "i" * 7 + "s"


def test_chain_and_head_entries_are_declared():
    """The fused K3, K7c and K7 entries, as ops/decode_flash.py passes them;
    the old chains' entries (K7c's `head_topk_partial`, K7's `head_topk`
    and `layernorm_f32`) are gone."""
    entries = _entries()
    assert entries["decode_chain_fused"] == "p" + "ii" + "p" * 17 + "i" * 14 + "s"
    assert entries["head_partial_fused"] == "p" * 12 + "i" * 7 + "s"
    assert entries["head_fused"] == "p" * 10 + "i" * 7 + "s"
    assert not {"head_topk_partial", "head_topk", "layernorm_f32"} & set(entries)


@pytest.mark.parametrize("name", sorted(kernels._SIGS))
def test_entry_point_parameters_match_sigs(name):
    """Pointers as c_void_p, ints as c_int, floats as c_float, and the
    stream last: a mismatch would pass a pointer cut to 32 bits."""
    assert _entries()[name] == kernels._SIGS[name] + "s"
