"""The port's data layer and host utilities against the JAX package's.

`stjep_tpu_torch/data/dataset.py`, `utils/metrics.py`, `utils/misc.py`
and the config helpers are copies of JAX modules that import no JAX (or
only for `round_up8`): the same files and seed give the same vocabularies,
ids, batch order and padding, and the same scores. The native loader
(`data/native/fastloader.cpp`, built by the port) gives the numpy path's
features, and the device cache's quantization, byte estimate and gather
give JAX's (here on the CPU). Tolerances: exact, except features through
CMVN (float32, 1e-6 relative: the native loader and numpy round the same
formula in another order) and dequantized gathers (exact in f32).
"""

import os
import random

import numpy as np
import pytest
import torch

from stjep_tpu import config as jconfig
from stjep_tpu.data import dataset as jdataset
from stjep_tpu.data import device_cache as jcache
from stjep_tpu.utils import metrics as jmetrics
from stjep_tpu.utils import misc as jmisc

from stjep_tpu_torch import config as tconfig
from stjep_tpu_torch.data import dataset as tdataset
from stjep_tpu_torch.data import device_cache as tcache
from stjep_tpu_torch.data import loader as tloader
from stjep_tpu_torch.utils import metrics as tmetrics
from stjep_tpu_torch.utils import misc as tmisc

from tests.data_factory import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n_sent=40)


# ------------------------------------------------------------- config


def test_config_helpers_match(tmp_path):
    for name in ("PAD_TOKEN", "UNK_TOKEN", "BOS_TOKEN", "EOS_TOKEN", "SPC_TOKEN"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    raw = {"a": "True", "b": "false", "c": "None", "d": "x", "e": 3, "f": "NONE"}
    assert tconfig.validate_config(dict(raw)) == jconfig.validate_config(dict(raw))
    conf = {"mode": "ASR_ST", "lr": 0.001, "flag": True, "none": None, "n": 3}
    tconfig.save_config(conf, tmp_path / "t.cfg")
    jconfig.save_config(conf, tmp_path / "j.cfg")
    assert (tmp_path / "t.cfg").read_bytes() == (tmp_path / "j.cfg").read_bytes()
    (tmp_path / "r.cfg").write_text("a=3\nb=0.5\nc=True\nd=false\ne=path/x\nf=1e-4\n")
    assert tconfig.read_config(tmp_path / "r.cfg") == jconfig.read_config(tmp_path / "r.cfg")


# --------------------------------------------------------- metrics, misc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match(seed):
    rng = np.random.RandomState(seed)
    vocab = [f"t{i}" for i in range(6)]

    def sent():
        return [vocab[i] for i in rng.randint(0, len(vocab), rng.randint(0, 9))]

    hyps = [sent() for _ in range(12)]
    refs = [[sent() for _ in range(rng.randint(1, 3))] for _ in range(12)]
    refs[0] = [list(hyps[0])]  # one exact match
    assert tmetrics.corpus_bleu(hyps, refs) == jmetrics.corpus_bleu(hyps, refs)
    flat = [r[0] for r in refs]
    assert tmetrics.corpus_wer(hyps, flat) == jmetrics.corpus_wer(hyps, flat)
    for h, r in zip(hyps, flat):
        assert tmetrics.word_error_rate(h, r) == jmetrics.word_error_rate(h, r)


def test_misc_matches():
    id2word = {0: "<pad>", 1: "<unk>", 2: "<s>", 3: "</s>", 4: "<spc>", 5: "a", 6: "b"}
    rng = np.random.RandomState(0)
    hyp = rng.randint(0, 7, (5, 9))
    ref = rng.randint(0, 7, (5, 10))
    for use_type in ("char", "word"):
        assert (tmisc.add2corpus(hyp, ref, id2word, [], [], use_type)
                == jmisc.add2corpus(hyp, ref, id2word, [], [], use_type))
    words = ["a", "<spc>", "<pad>", "b", "</s>", "c"]
    for use_type, rev in (("char", False), ("word", True)):
        assert (tmisc.detok_words(words, use_type, rev)
                == jmisc.detok_words(words, use_type, rev))
    tmisc.set_global_seeds(7)
    a = (np.random.rand(), random.random())
    jmisc.set_global_seeds(7)
    assert a == (np.random.rand(), random.random())
    kb, mb, gb = tmisc.get_memory_alloc()
    assert kb >= 0 and mb == kb / 1024.0 and gb == mb / 1024.0


# ------------------------------------------------------------- dataset


def _pair(corpus, mode, **kw):
    args = dict(path_src=corpus["path_src"],
                path_tgt=corpus["path_tgt"] if mode != "ASR" else None,
                path_vocab_src=corpus["path_vocab_src"],
                path_vocab_tgt=corpus["path_vocab_tgt"],
                acous_path=corpus["acous_path"] if mode != "MT" else None,
                acous_norm_path=corpus["acous_norm_path"], acous_norm=(mode != "MT"),
                max_seq_len_src=6, max_seq_len_tgt=14, batch_size=7,
                use_type="char", mode=mode, seed=11)
    args.update(kw)
    return jdataset.Dataset(**args), tdataset.Dataset(**args)


@pytest.mark.parametrize("mode,kw", [
    ("ST", {}), ("ASR", {}), ("MT", {}),
    ("ST", {"length_bucket": True}), ("ASR", {"data_ratio": 0.5}),
    ("MT", {"use_type": "word", "seqrev": True, "length_bucket": True}),
])
def test_dataset_matches_jax(corpus, mode, kw):
    """Vocabularies, ids and lengths after filtering, three epochs of batch
    order, and every materialised batch (ids, padding, features)."""
    j, t = _pair(corpus, mode, **kw)
    for attr in ("vocab_src", "vocab_tgt", "src_word2id", "tgt_id2word", "vocab_size",
                 "train_src_word_ids", "train_tgt_word_ids", "train_acous_flis",
                 "train_acous_lengths", "train_acous_spkids", "num_training_sentences"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.num_training_sentences < 40  # the length filter dropped some
    for epoch in range(3):
        jb = j.construct_batches(is_train=epoch < 2)
        tb = t.construct_batches(is_train=epoch < 2)
        assert tb == jb, epoch
        for i in range(len(t)):
            a, b = j.materialise_batch(i), t.materialise_batch(i)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6, err_msg=k)
    if mode != "MT":
        a, b = j.materialise_batch(0, with_acous=False), t.materialise_batch(0, with_acous=False)
        assert a["_flis"] == b["_flis"]


def test_pretrained_embedding_overlay(tmp_path):
    (tmp_path / "emb.txt").write_text("3 2\nA 0.5 1.5\nzz 1 1\nb -1 2\n")
    w2i = {"a": 1, "b": 2}
    m1 = tdataset.load_pretrained_embedding(w2i, np.zeros((3, 2)), str(tmp_path / "emb.txt"))
    m2 = jdataset.load_pretrained_embedding(w2i, np.zeros((3, 2)), str(tmp_path / "emb.txt"))
    np.testing.assert_array_equal(m1, m2)


# -------------------------------------------------------------- loader


@pytest.mark.parametrize("norm", [False, True])
def test_native_loader_equals_numpy_path(corpus, norm):
    native = tloader.get_native_loader()
    assert native is not None, "g++ builds the loader on this host"
    assert os.path.exists(tloader.library_path())
    _, t = _pair(corpus, "ST", max_seq_len_src=32, max_seq_len_tgt=300)
    flis, lens = t.train_acous_flis[:9], t.train_acous_lengths[:9]
    norm_param = t.load_mu_std(t.train_acous_spkids[:9]) if norm else None
    calls = tloader.NativeLoader.calls
    got = t.load_acous(flis, norm_param=norm_param, lengths=lens)
    assert tloader.NativeLoader.calls == calls + 1
    ref = t.load_acous(flis, norm_param=norm_param)  # no lengths: the numpy path
    assert tloader.NativeLoader.calls == calls + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert got.shape[1] == max(lens) + 8 - max(lens) % 8


def test_host_prefetch_order_errors_and_abandon():
    assert list(tloader.host_prefetch(iter(range(20)), size=2)) == list(range(20))

    def bad():
        yield 1
        raise KeyError("producer")

    with pytest.raises(KeyError, match="producer"):
        list(tloader.host_prefetch(bad()))
    gen = tloader.host_prefetch(iter(range(10 ** 6)), size=2)
    assert next(gen) == 0
    gen.close()  # the producer stops instead of filling the queue forever
    out = list(tloader.prefetch_to_device(iter([{"x": np.arange(3)}]), device="cpu"))
    assert torch.equal(out[0]["x"], torch.arange(3))


# -------------------------------------------------------- device cache


def test_quantize_and_estimate_match(corpus):
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 3, 16, 5).astype(np.float32)
    feats[0, 1] = 0.0  # an all-zero utterance: scale 0, q 0
    a, b = tcache.quantize_batch(feats, np.float32), jcache.quantize_batch(feats, np.float32)
    np.testing.assert_array_equal(a["q"], b["q"])
    np.testing.assert_array_equal(a["scale"], b["scale"])
    deq = tcache.dequantize(torch.from_numpy(a["q"]), torch.from_numpy(a["scale"]))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jcache.dequantize(b["q"], b["scale"])))
    j, t = _pair(corpus, "ST", max_seq_len_src=32, max_seq_len_tgt=300)
    import ml_dtypes

    for jd, td in ((np.float32, np.float32), (ml_dtypes.bfloat16, "bfloat16"),
                   (np.int8, "int8")):
        for bucket in (8, 64, 256):
            assert (tcache.estimate_corpus_bytes(t, bucket, td)
                    == jcache.estimate_corpus_bytes(j, bucket, jd)), (td, bucket)
    os.environ["STJEP_CACHE_BUDGET_MB"] = "3"
    try:
        assert tcache.hbm_cache_budget() == jcache.hbm_cache_budget() == 3 * 2 ** 20
    finally:
        del os.environ["STJEP_CACHE_BUDGET_MB"]
    assert tcache.hbm_cache_budget(device="cpu") == 0


@pytest.mark.parametrize("feat_dtype", ["float32", "int8"])
def test_device_cache_matches_jax(corpus, feat_dtype):
    """The resident corpus (features, scales, rows) and a minibatch gathered
    from it, on the CPU, equal JAX's."""
    import jax.numpy as jnp

    j, t = _pair(corpus, "ST", max_seq_len_src=32, max_seq_len_tgt=300)
    jd = np.int8 if feat_dtype == "int8" else np.float32
    jc = jcache.DeviceFeatureCache.build(j, 64, jd)
    tc = tcache.DeviceFeatureCache.build(t, 64, feat_dtype, device="cpu")
    assert tc.t_max == jc.t_max and tc.nbytes == jc.nbytes
    np.testing.assert_allclose(tc.feats.float().numpy(), np.asarray(jc.feats, np.float32),
                               rtol=1e-6, atol=1e-6)
    if feat_dtype == "int8":
        np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    flis = t.train_acous_flis[3:9]
    np.testing.assert_array_equal(tc.rows(flis), jc.rows(flis))
    idx = tc.rows(flis)
    got = tcache.gather_features(tc.arrays, torch.from_numpy(idx), 32)
    ref = jcache.gather_features(jc.arrays, jnp.asarray(idx), 32)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    bf = tcache.gather_features(tc.arrays, torch.from_numpy(idx), 32, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
