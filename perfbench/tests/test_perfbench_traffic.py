"""The host pools: exact repeats for a seed, other draws for another, and
the same work (the same lengths, in another order) for every seed."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import registry, traffic as traffic_mod

BENCH = registry.benchmark()
MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})
MODEL = registry.config(BENCH, "stjep-standard")["model"]
SEEDS = (7, 2 ** 31 + 12345, 4_100_000_000)


def small(name):
    """The mix with a smaller pool, so the test draws little."""
    return {**registry.traffic(name), "pool": 2}


@pytest.mark.parametrize("mix", MIXES)
def test_pool_repeats_for_a_seed_and_differs_across_seeds(mix):
    a = traffic_mod.make_pool(small(mix), MODEL, SEEDS[1])
    b = traffic_mod.make_pool(small(mix), MODEL, SEEDS[1])
    c = traffic_mod.make_pool(small(mix), MODEL, SEEDS[2])
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys() == z.keys()
        for k in x:
            assert np.array_equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        assert any(not np.array_equal(x[k], z[k]) for k in x)


def lengths(b):
    """Each length the batch holds, sorted, by kind, and its shapes."""
    out = {k: tuple(v.shape) for k, v in b.items()}
    if "acouslen" in b:
        out["frames"] = sorted(b["acouslen"].tolist())
    for k in ("srcid", "tgtid"):
        if k in b:
            out[k + "_len"] = sorted((b[k] != 0).sum(1).tolist())
    return out


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_lengths(mix):
    tr = small(mix)
    got = [[lengths(b) for b in traffic_mod.make_pool(tr, MODEL, s)] for s in SEEDS]
    assert got[0] == got[1] == got[2]
    assert all(x == got[0][0] for x in got[0])


def test_decode_lengths_and_padding():
    tr = small("st_beam_b64")
    b = traffic_mod.make_pool(tr, MODEL, 3)[0]
    lens = b["acouslen"]
    assert lens.min() == 400 and lens.max() == 1504 and len(lens) == 64
    assert b["acous_feat"].shape == (64, 1512, 40)  # round_up8(1504)
    for r in range(64):
        assert not b["acous_feat"][r, lens[r]:].any() and b["acous_feat"][r, lens[r] - 1].any()


def test_ids_layout():
    tr = small("train_mt_b64")
    b = traffic_mod.make_pool(tr, MODEL, 3)[0]
    for ids, (lo, hi), pad in ((b["srcid"], tr["src_len"], 90), (b["tgtid"], tr["tgt_len"], 150)):
        n = (ids != 0).sum(1)
        assert ids.shape[1] == pad and n.min() == lo and n.max() == hi
        assert (ids[:, 0] == 2).all()
        assert all(ids[r, n[r] - 1] == 3 for r in range(len(n)))
