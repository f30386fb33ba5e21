"""The fused decode kernels' plan (ops/decode_flash.py `fused_tiles`,
`fused_plan`) and the C signatures of every kernel entry point, on the CPU.

The fused K5 and K4 (csrc/decode_fused.cu) walk the tile table that
`fused_tiles` builds from the shapes alone, passed to them as `tiles`;
these tests hold that table in numpy: every output element of every
product phase is written by exactly one tile, each split covers its slice
of the contraction once, the dynamic shared memory fits a Hopper block, the
workspace holds every phase's partials, and nothing depends on how many
blocks the card keeps resident. The second half parses every `extern "C"`
entry of csrc/*.cu and holds its parameter kinds against kernels._SIGS,
the argument types ctypes passes.
"""

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
    fused_plan,
    fused_tiles,
)

SMEM_MAX = 232448  # the shared memory an H100 block may opt in to

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


def _table(BK, D, FF, V):
    """{kind: [(job, split, first row, first column)]} from the table the
    kernels read, checking its header: one offset per kind, then the end."""
    t = fused_tiles(BK, D, FF, V).numpy()
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
    items = dict(plan["phases"])
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


@pytest.mark.parametrize("name", sorted(kernels._SIGS))
def test_entry_point_parameters_match_sigs(name):
    """Pointers as c_void_p, ints as c_int, floats as c_float, and the
    stream last: a mismatch would pass a pointer cut to 32 bits."""
    assert _entries()[name] == kernels._SIGS[name] + "s"
