"""The fused LAS kernels' plan (ops/las_flash.py `las_plan`, `las_tiles`),
on the CPU.

The fused K2 and K9 (csrc/las_fused.cu) walk the item table `las_tiles`
builds from the shapes alone, passed to them as `tiles`; these tests hold
that table in numpy: every output element of every phase is written by
exactly one item, each attention row's keys are split into chunks that
cover them once (a product item runs its whole contraction, so the key
chunks are the only split the table holds), the dynamic shared memory fits
a Hopper block, the workspace holds every partial, and nothing depends on
how many blocks the card keeps resident. Also the gate packing the
forward's weights take, and the widths the wrappers refuse before a launch.
"""

import numpy as np
import pytest
import torch

from stjep_tpu_torch.ops.las_flash import (
    LAS_BM,
    LAS_KINDS,
    LAS_KEYS,
    LAS_NJ,
    LAS_SMEM_MAX,
    LAS_UNITS,
    LAS_WJ,
    check_widths,
    key_chunks,
    las_plan,
    las_tiles,
    pack_gates,
)

# (B, Tk, Hd, Hs, Ha2, E, V, nl): the flagship (bench.py: B 16, 1504 frames
# -> 188 keys, widths 512, E 200, 30 000 source ids, 3 decoder LSTMs), the
# serving batches, the longest keys the old per-row attention took, the
# card tests' small shapes and widths off every tile
SHAPES = {
    "flagship": (16, 188, 512, 512, 512, 200, 30000, 3),
    "B1": (1, 188, 512, 512, 512, 200, 30000, 3),
    "B64": (64, 188, 512, 512, 512, 200, 30000, 3),
    "Tk3000": (16, 3000, 512, 512, 512, 200, 32, 1),
    "Tk11700": (16, 11700, 512, 512, 512, 200, 32, 3),
    "tests": (5, 9, 128, 128, 128, 16, 50, 3),
    "ragged": (3, 37, 128, 128, 256, 16, 37, 4),
}
KINDS = ("greedy", "tf_fwd", "tf_bwd")


def _table(kind, B, Tk, Hd, Hs, Ha2, V):
    """{item kind: int array [n, 4]} from the table the kernels read,
    checking its header: one offset per kind, then the end."""
    t = las_tiles(kind, B, Tk, Hd, Hs, Ha2, V).numpy()
    n = len(LAS_KINDS)
    off, rows = t[:n + 1], t[n + 1:].reshape(-1, 4)
    assert off[0] == 0 and off[-1] == len(rows) and (np.diff(off) >= 0).all()
    return {k: rows[off[i]:off[i + 1]] for i, k in enumerate(LAS_KINDS)}


def _plan(kind, shape, steps=5):
    B, Tk, Hd, Hs, Ha2, E, V, nl = SHAPES[shape]
    if kind != "greedy":
        E, V, nl = 0, 0, 3
    return las_plan(kind, B, Tk, Hd, Hs, Ha2, E=E, V=V, nl=nl, steps=steps)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_every_output_element_written_once(shape, kind):
    """Per item kind: the [B, width] outputs its items own (an LSTM item 2
    units of 16 rows, a narrow product item 8 columns, a head item 128 ids)
    each covered by exactly one item; a kind the launch does not run has no
    items."""
    B, Tk, Hd, Hs, Ha2, E, V, nl = SHAPES[shape]
    table = _table(kind, B, Tk, Hd, Hs, Ha2, V if kind == "greedy" else 0)
    widths = {"lstm": (Hd, LAS_UNITS), "ffn": (Hs, LAS_NJ), "head": (V, LAS_WJ),
              "ffn_t": (Ha2 + Hd, LAS_NJ), "lstm_t": (2 * Hd, LAS_NJ), "l0_t": (Hs + Hd, LAS_NJ)}
    runs = {"greedy": {"lstm", "att", "ffn", "head"}, "tf_fwd": {"lstm", "att", "ffn"},
            "tf_bwd": {"att", "ffn_t", "lstm_t", "l0_t"}}[kind]
    for name, (n, w) in widths.items():
        rows = table[name]
        assert (len(rows) > 0) == (name in runs), name
        out = np.zeros((B, n), np.int64)
        for r0, c0, _, _ in rows:
            assert r0 % LAS_BM == 0 and c0 % w == 0
            out[r0:r0 + LAS_BM, c0:c0 + w] += 1
        if name in runs:
            assert (out == 1).all(), name
    assert set(runs) | {"att"} == {k for k in LAS_KINDS if len(table[k])}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_attention_chunks_cover_each_row_once(shape):
    """Each attention row's keys [0, Tk) split into chunks of 16 (the last
    ragged) that cover them once, numbered 0 .. nc - 1 in key order: the
    order the row's merge sums them in."""
    B, Tk, Hd, Hs, Ha2, *_ = SHAPES[shape]
    att = _table("greedy", B, Tk, Hd, Hs, Ha2, 32)["att"]
    tc, nc = key_chunks(Tk)
    assert tc == LAS_KEYS and len(att) == B * nc
    for b in range(B):
        items = att[att[:, 0] == b]
        assert list(items[:, 3]) == list(range(nc))
        keys = np.zeros(Tk, np.int64)
        for _, t0, t1, _ in items:
            assert 0 < t1 - t0 <= tc
            keys[t0:t1] += 1
        assert (keys == 1).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_shared_memory_and_workspace_fit(shape, kind):
    """The dynamic shared memory fits a block and holds an attention item's
    rows; the workspace is its regions, each 16-byte aligned and holding
    what the items write: the carried state, the head's partial per 128-id
    tile and row, the attention partials per (row, chunk), a ticket a row."""
    B, Tk, Hd, Hs, Ha2, E, V, nl = SHAPES[shape]
    plan = _plan(kind, shape)
    tc, nc = plan["tc"], plan["nc"]
    assert 0 < plan["smem"] <= LAS_SMEM_MAX
    att = Ha2 + tc * (Ha2 + Hd) + 2 * tc if kind == "tf_bwd" else Hd + tc * (Hd + Ha2) + tc + nc
    assert plan["smem"] >= 4 * att
    r = plan["regions"]
    assert all(v % 4 == 0 for v in r.values()) and plan["ws_floats"] == sum(r.values())
    need = {"CNT": B}
    if kind == "greedy":
        P = -(-V // LAS_WJ)
        need.update(X0=2 * B * (Hs + Hd), XL=(nl - 1) * 2 * B * 2 * Hd, C=nl * B * Hd,
                    FF=B * (Ha2 + Hd), HM=B * P, HI=B * P, HS=B * P, REF=B)
    if kind == "tf_bwd":
        need.update(DH=3 * B * Hd, DC=3 * B * Hd, DY1=B * Hd, DFFQ=B * Hd, AS=B * nc,
                    AP1=B * nc * Hd, AP2=B * nc * Hd, DATT=B * Tk)
    else:
        need.update(AM=B * nc, AZ=B * nc, ACTX=B * nc * Ha2, SC=B * Tk)
    assert set(r) == set(need)
    for k, n in need.items():
        assert n <= r[k] < n + 4, k


@pytest.mark.parametrize("kind,steps", [("greedy", 89), ("greedy", 1), ("tf_fwd", 89),
                                        ("tf_fwd", 1), ("tf_bwd", 89), ("tf_bwd", 1)])
def test_phases_and_barriers(kind, steps):
    """K2: nl LSTM phases, attention, FFN, head a step, then the outputs,
    (nl + 3) barriers a step (6 at the recipe's 3 layers); K9 forward: 3
    LSTM phases, attention, FFN, 5 a step less the last; K9 backward:
    ffn_t, attention, two lstm_t and l0_t a reverse step, none of l0_t at
    t = 0, 5 a step less 2. Every phase's work items are its table's."""
    plan = _plan(kind, "flagship", steps)
    names = [n for n, _ in plan["phases"]]
    assert plan["barriers"] == len(names) - 1
    assert plan["barriers"] == {"greedy": 6 * steps, "tf_fwd": 5 * steps - 1,
                                "tf_bwd": 5 * steps - 2}[kind]
    if kind == "greedy":
        assert names[:6] == ["lstm"] * 3 + ["att", "ffn", "head"] and names[-1] == "outputs"
    if kind == "tf_bwd":
        assert names.count("l0_t") == steps - 1 and names[-1] == "lstm_t"
    for name, n in plan["phases"]:
        if name != "outputs":
            assert n == plan["items"][name] > 0, name


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_items_do_not_change_with_the_grid(sms, per_sm):
    """Neither the plan nor the item table takes an SM count, and the
    kernels' block-strided walk over a phase's items gives every item to
    exactly one block at any grid size (7 blocks, the card tests' other
    grid, included)."""
    for kind in KINDS:
        B, Tk, Hd, Hs, Ha2, E, V, nl = SHAPES["flagship"]
        if kind != "greedy":
            E, V, nl = 0, 0, 3
        plan = las_plan(kind, B, Tk, Hd, Hs, Ha2, E=E, V=V, nl=nl, steps=5)
        assert las_plan.__wrapped__(kind, B, Tk, Hd, Hs, Ha2, E=E, V=V, nl=nl, steps=5) == plan
        t = las_tiles(kind, B, Tk, Hd, Hs, Ha2, V)
        assert torch.equal(t, las_tiles(kind, B, Tk, Hd, Hs, Ha2, V))
        for grid in (sms * per_sm, 7):
            for name, n in plan["phases"]:
                seen = np.zeros(n, np.int64)
                for blk in range(grid):
                    seen[blk:n:grid] += 1
                assert (seen == 1).all(), name


def test_pack_gates_puts_a_units_gates_together():
    """Column 4u + g of the packed weights is column g * H + u of the
    unpacked ones."""
    rng = np.random.RandomState(0)
    K, H = 7, 5
    w = rng.randn(K, 4 * H).astype(np.float32)
    packed = pack_gates(torch.from_numpy(w)).numpy()
    for u in range(H):
        for g in range(4):
            assert np.array_equal(packed[:, 4 * u + g], w[:, g * H + u])


@pytest.mark.parametrize("bad", [
    dict(Hd=130), dict(Hs=12), dict(Ha2=6), dict(E=2), dict(B=0), dict(Tk=0),
    dict(Hd=8192, Ha2=8192)])
def test_widths_refused_before_a_launch(bad):
    """Widths off the 16-byte weight rows, an empty batch or key set, and
    an attention chunk too wide for a block's shared memory raise with the
    reason."""
    args = dict(B=16, Tk=188, Hd=512, Hs=512, Ha2=512, E=200)
    args.update(bad)
    plan = las_plan("greedy", args["B"], args["Tk"], args["Hd"], args["Hs"], args["Ha2"],
                    E=args["E"], V=32)
    with pytest.raises(ValueError, match="cannot run this shape"):
        check_widths(**args, ws_floats=plan["ws_floats"], smem=plan["smem"])
