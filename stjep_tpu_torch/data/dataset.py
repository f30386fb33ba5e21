"""Host-side dataset: vocab, tokenisation, batching, lazy fbank loading.

A copy of stjep_tpu/data/dataset.py on the port's own `ops/masks.py
round_up8` (the JAX module reaches it through its ops/masks.py, which
imports JAX) and the port's native loader (`data/loader.py`).
tests/test_torch_data.py pins the two: for the same files and seed, the
same vocabularies, ids, batch order and padding.

Rebuild of the reference input pipeline (ref: utils/dataset.py:18-651) with
the same observable behavior:

- vocab files: one token per line, id = LINE NUMBER (blank lines consume an
  id but map no token — ref: dataset.py:265-271 enumerates all lines)
- word-level src tokenisation, char- or word-level tgt with <spc> for spaces,
  BOS/EOS wrapping, UNK fallback (ref: dataset.py:405-427)
- length filtering: src/tgt <= max_seq_len-2, acoustics <= acous_max_len
  (ref: dataset.py:391-399)
- per-epoch shuffle + macro-batching (ref: dataset.py:561-611)
- token ids padded to the FIXED max_seq_len (static shapes — the
  reference does the same via its dummy-row trick, ref: dataset.py:53-63)
- lazy per-utterance fbank npy loading, per-speaker CMVN from
  {spk}.mu.npy/.std.npy, padding to a multiple of 8 via the x+8-x%8 formula
  (ref: dataset.py:122-184)

Additions over the reference: numpy (not torch) outputs, optional
length-bucketed batching (fewer distinct batch shapes), and a background
prefetch iterator (data/loader.py).
"""

from __future__ import annotations

import collections
import logging
import random
from os.path import join
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from stjep_tpu_torch.config import BOS, EOS, PAD, SPC, UNK
from stjep_tpu_torch.ops.masks import round_up8

logger = logging.getLogger(__name__)


def load_vocab_file(path: str):
    """(vocab list, word2id, id2word) — ref: dataset.py:260-281."""
    vocab: List[str] = []
    word2id: "collections.OrderedDict[str, int]" = collections.OrderedDict()
    id2word: "collections.OrderedDict[int, str]" = collections.OrderedDict()
    with open(path, encoding="UTF-8") as f:
        lines = f.readlines()
    for i, word in enumerate(lines):
        if word == "\n":
            continue
        word = word.strip().split()[0]
        vocab.append(word)
        word2id[word] = i
        id2word[i] = word
    return vocab, word2id, id2word


def vocab_from_list(vocab_list: Sequence[str]):
    """ref: dataset.py:283-297 (load from saved vocab list)."""
    vocab: List[str] = []
    word2id: "collections.OrderedDict[str, int]" = collections.OrderedDict()
    id2word: "collections.OrderedDict[int, str]" = collections.OrderedDict()
    for i, word in enumerate(vocab_list):
        vocab.append(word)
        word2id[word] = i
        id2word[i] = word
    return vocab, word2id, id2word


def tokenize_src(words: List[str], word2id) -> List[int]:
    """BOS + word ids (UNK fallback) + EOS — ref: dataset.py:405-414."""
    ids = [BOS]
    for word in words:
        assert word != " "
        ids.append(word2id.get(word, UNK))
    ids.append(EOS)
    return ids


def tokenize_tgt(tokens, word2id, use_type: str) -> List[int]:
    """BOS + char/word ids with <spc> for spaces + EOS
    (ref: dataset.py:417-427)."""
    ids = [BOS]
    for tok in tokens:
        if tok == " ":
            assert use_type == "char"
            ids.append(SPC)
        else:
            ids.append(word2id.get(tok, UNK))
    ids.append(EOS)
    return ids


class Dataset:
    """ref: utils/dataset.py:187-628 — same ctor surface, numpy outputs."""

    def __init__(
        self,
        path_src: Optional[str] = None,
        path_tgt: Optional[str] = None,
        path_vocab_src: Optional[str] = None,
        path_vocab_tgt: Optional[str] = None,
        vocab_src_list: Optional[Sequence[str]] = None,
        vocab_tgt_list: Optional[Sequence[str]] = None,
        acous_path: Optional[str] = None,
        acous_norm_path: Optional[str] = None,
        max_seq_len_src: int = 32,
        max_seq_len_tgt: int = 300,
        batch_size: int = 64,
        use_gpu: bool = True,  # kept for flag parity; unused
        logger=None,
        seqrev: bool = False,
        acous_norm: bool = False,
        acous_max_len: int = 1500,
        use_type: str = "char",
        data_ratio: float = 1.0,
        mode: str = "ST",
        seed: Optional[int] = None,
        length_bucket: bool = False,
    ):
        self.path_src = path_src
        self.path_tgt = path_tgt
        self.acous_path = acous_path
        self.acous_norm_path = acous_norm_path
        self.max_seq_len_src = max_seq_len_src
        self.max_seq_len_tgt = max_seq_len_tgt
        self.batch_size = batch_size
        self.seqrev = seqrev
        # fail fast with a clear message instead of the reference's mid-
        # training TypeError from join(None, spkid) (ref: dataset.py:139-146)
        if acous_norm and acous_path is not None and acous_norm_path is None:
            raise ValueError(
                "acous_norm is enabled but no acoustic-norm path was given "
                "— pass the CMVN stats dir (--{st,asr_train,asr_dev,test}_"
                "acous_norm_path) or disable --las_acous_norm")
        self.acous_norm = acous_norm
        self.acous_max_len = acous_max_len
        self.use_type = use_type
        self.data_ratio = data_ratio
        self.mode = mode
        self.length_bucket = length_bucket
        self._rng = random.Random(seed)
        self.logger = logger or logging.getLogger(__name__)

        # vocab
        if path_vocab_src is not None or path_vocab_tgt is not None:
            if path_vocab_src is not None:
                self.vocab_src, self.src_word2id, self.src_id2word = (
                    load_vocab_file(path_vocab_src)
                )
            if path_vocab_tgt is not None:
                self.vocab_tgt, self.tgt_word2id, self.tgt_id2word = (
                    load_vocab_file(path_vocab_tgt)
                )
        else:
            assert vocab_src_list is not None and vocab_tgt_list is not None
            self.vocab_src, self.src_word2id, self.src_id2word = vocab_from_list(
                vocab_src_list
            )
            self.vocab_tgt, self.tgt_word2id, self.tgt_id2word = vocab_from_list(
                vocab_tgt_list
            )

        self.load_sentences()
        self.load_acous_flis()
        self.preprocess(mode=self.mode)
        self.batches: List[Dict] = []

    # ------------------------------------------------------------------ IO

    def load_sentences(self):
        """ref: dataset.py:300-319."""
        self.src_sentences: List[str] = []
        self.tgt_sentences: List[str] = []
        if self.path_src is not None:
            with open(self.path_src, encoding="UTF-8") as f:
                self.src_sentences = f.readlines()
        if self.path_tgt is not None:
            with open(self.path_tgt, encoding="UTF-8") as f:
                self.tgt_sentences = f.readlines()
            assert len(self.src_sentences) == len(self.tgt_sentences), (
                "Mismatch src:tgt - {}:{}".format(
                    len(self.src_sentences), len(self.tgt_sentences)
                )
            )
            if self.seqrev:
                for idx in range(len(self.tgt_sentences)):
                    rev = self.tgt_sentences[idx].strip().split()[::-1]
                    self.tgt_sentences[idx] = " ".join(rev)

    def load_acous_flis(self):
        """acoustic npy file list: `fname length spkid` — ref: dataset.py:322-340."""
        self.acous_flis: List[str] = []
        self.acous_length_lis: List[int] = []
        self.acous_spkids: List[str] = []
        if self.acous_path is not None:
            with open(self.acous_path) as f:
                for line in f:
                    elems = line.strip().split()
                    if not elems:
                        continue
                    self.acous_flis.append(elems[0])
                    self.acous_length_lis.append(int(elems[1]))
                    self.acous_spkids.append(elems[2].split(".")[0])

    # --------------------------------------------------------- preprocess

    def preprocess(self, mode: str = "ST"):
        """Tokenise + length-filter (ref: dataset.py:343-558)."""
        self.vocab_size = {"src": len(self.src_word2id), "tgt": len(self.tgt_word2id)}
        self.logger.info("num_vocab_src: %d", self.vocab_size["src"])
        self.logger.info("num_vocab_tgt: %d", self.vocab_size["tgt"])

        src_ids_all: List[List[int]] = []
        src_lens: List[int] = []
        tgt_ids_all: List[List[int]] = []
        tgt_lens: List[int] = []
        flis: List[str] = []
        spkids: List[str] = []
        alens: List[int] = []

        partial_n = int(len(self.src_sentences) * self.data_ratio)

        def _tgt_tokens(sentence: str):
            if self.use_type == "char":
                return sentence.strip()
            return sentence.strip().split()

        if "ST" in mode:
            assert len(self.acous_flis) == len(self.src_sentences), (
                "mismatch acoustics and src sentences"
            )
            for idx in range(partial_n):
                src_words = self.src_sentences[idx].strip().split()
                tgt_words = _tgt_tokens(self.tgt_sentences[idx])
                if (
                    len(src_words) > self.max_seq_len_src - 2
                    or len(tgt_words) > self.max_seq_len_tgt - 2
                ):
                    continue
                if self.acous_length_lis[idx] > self.acous_max_len:
                    continue
                flis.append(self.acous_flis[idx])
                spkids.append(self.acous_spkids[idx])
                alens.append(self.acous_length_lis[idx])
                src_ids_all.append(tokenize_src(src_words, self.src_word2id))
                src_lens.append(len(src_words) + 2)
                tgt_ids_all.append(
                    tokenize_tgt(tgt_words, self.tgt_word2id, self.use_type)
                )
                tgt_lens.append(len(tgt_words) + 2)

        elif "MT" in mode:
            assert len(self.src_sentences) == len(self.tgt_sentences), (
                "mismatch src and tgt sentences"
            )
            for idx in range(partial_n):
                src_words = self.src_sentences[idx].strip().split()
                tgt_words = _tgt_tokens(self.tgt_sentences[idx])
                if (
                    len(src_words) > self.max_seq_len_src - 2
                    or len(tgt_words) > self.max_seq_len_tgt - 2
                ):
                    continue
                flis.append("")
                spkids.append("")
                alens.append(0)
                src_ids_all.append(tokenize_src(src_words, self.src_word2id))
                src_lens.append(len(src_words) + 2)
                tgt_ids_all.append(
                    tokenize_tgt(tgt_words, self.tgt_word2id, self.use_type)
                )
                tgt_lens.append(len(tgt_words) + 2)

        elif "ASR" in mode:
            assert len(self.acous_flis) == len(self.src_sentences), (
                "mismatch acoustics and src sentences"
            )
            for idx in range(partial_n):
                src_words = self.src_sentences[idx].strip().split()
                if len(src_words) > self.max_seq_len_src - 2:
                    continue
                if self.acous_length_lis[idx] > self.acous_max_len:
                    continue
                flis.append(self.acous_flis[idx])
                spkids.append(self.acous_spkids[idx])
                alens.append(self.acous_length_lis[idx])
                src_ids_all.append(tokenize_src(src_words, self.src_word2id))
                src_lens.append(len(src_words) + 2)
                tgt_ids_all.append([BOS, EOS])  # dummy tgt (ref: dataset.py:536)
                tgt_lens.append(2)

        self.train_src_word_ids = src_ids_all
        self.train_src_sentence_lengths = src_lens
        self.train_tgt_word_ids = tgt_ids_all
        self.train_tgt_sentence_lengths = tgt_lens
        self.train_acous_flis = flis
        self.train_acous_spkids = spkids
        self.train_acous_lengths = alens
        self.num_training_sentences = len(src_ids_all)
        self.logger.info("num_sentences: %d", self.num_training_sentences)

    # ------------------------------------------------------------ batching

    def construct_batches(self, is_train: bool = False):
        """Shuffle (train) / bucket, then macro-batch (ref: dataset.py:561-611)."""
        _x = list(
            zip(
                self.train_src_word_ids,
                self.train_src_sentence_lengths,
                self.train_tgt_word_ids,
                self.train_tgt_sentence_lengths,
                self.train_acous_flis,
                self.train_acous_spkids,
                self.train_acous_lengths,
            )
        )
        if is_train:
            self._rng.shuffle(_x)
        if self.length_bucket and _x:
            # sort by acoustic (or src) length so each macro batch has a
            # near-uniform padded shape -> fewer distinct shapes and less
            # wasted compute. Batch order is shuffled below.
            keyfn = (lambda r: r[6]) if any(r[6] for r in _x) else (lambda r: r[1])
            _x = sorted(_x, key=keyfn)

        n = len(_x)
        n_batches = n // self.batch_size + int(n % self.batch_size > 0)
        batches = []
        for i in range(n_batches):
            chunk = _x[i * self.batch_size : min((i + 1) * self.batch_size, n)]
            (src_ids, src_l, tgt_ids, tgt_l, fl, spk, al) = map(list, zip(*chunk))
            batches.append(
                {
                    "src_word_ids": src_ids,
                    "src_sentence_lengths": src_l,
                    "tgt_word_ids": tgt_ids,
                    "tgt_sentence_lengths": tgt_l,
                    "acous_flis": fl,
                    "acous_spkids": spk,
                    "acous_lengths": al,
                }
            )
        if is_train and self.length_bucket:
            self._rng.shuffle(batches)
        self.batches = batches
        return batches

    def __len__(self):
        return len(self.batches)

    # ------------------------------------------------------- materialise

    def _pad_ids(self, seqs: List[List[int]], max_len: int) -> np.ndarray:
        out = np.full((len(seqs), max_len), PAD, dtype=np.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s[:max_len]
        return out

    def load_mu_std(self, spkids: List[str]):
        """Per-speaker CMVN stats (ref: dataset.py:134-154)."""
        norm_param = []
        cache: Dict[str, list] = {}
        base = self.acous_norm_path
        for spkid in spkids:
            if spkid not in cache:
                mu = np.load(join(base, spkid + ".mu.npy"))
                std = np.load(join(base, spkid + ".std.npy"))
                cache[spkid] = [mu, std]
            norm_param.append(cache[spkid])
        return norm_param

    def load_acous(self, flis: List[str], norm_param=None,
                   lengths: Optional[List[int]] = None) -> np.ndarray:
        """Load + CMVN + pad to multiple of 8 (ref: dataset.py:157-184).

        Uses the native C++ threaded loader when available (data/loader.py);
        falls back to the numpy path."""
        if lengths is not None and flis and flis[0]:
            from stjep_tpu_torch.data.loader import get_native_loader

            native = get_native_loader()
            if native is not None:
                T = int(round_up8(max(lengths)))
                probe = np.load(flis[0], mmap_mode="r")
                D = probe.shape[1]
                try:
                    return native.load_batch(flis, T, D, norm_param=norm_param)
                except RuntimeError:
                    pass  # fall back to numpy below
        feats = []
        max_len = 0
        acous_dim = None
        for idx, f in enumerate(flis):
            arr = np.load(f)
            acous_dim = arr.shape[1]
            if norm_param is not None:
                mu, std = norm_param[idx]
                if mu.shape[0] != acous_dim:
                    mu = mu[:acous_dim]  # drop training energy term
                    std = std[:acous_dim]
                arr = 1.0 * (arr - mu) / std
            feats.append(arr.astype(np.float32))
            max_len = max(max_len, arr.shape[0])
        T = int(round_up8(max_len))
        out = np.zeros((len(feats), T, acous_dim), dtype=np.float32)
        for i, a in enumerate(feats):
            out[i, : a.shape[0]] = a
        return out

    def materialise_batch(self, index: int,
                          with_acous: bool = True) -> Dict[str, np.ndarray]:
        """ref: IterDataset.__getitem__ (dataset.py:48-119).

        with_acous=False skips the np.load/CMVN and instead carries the
        batch's file list under "_flis" — the trainer's device-resident
        feature cache (data/device_cache.py) resolves those to on-device
        rows, so the features never touch the host path again."""
        b = self.batches[index]
        item: Dict[str, np.ndarray] = {}
        if "ST" in self.mode or "ASR" in self.mode or "MT" in self.mode:
            item["srcid"] = self._pad_ids(b["src_word_ids"], self.max_seq_len_src)
            item["srclen"] = np.asarray(b["src_sentence_lengths"], np.int32)
        if "ST" in self.mode or "MT" in self.mode:
            item["tgtid"] = self._pad_ids(b["tgt_word_ids"], self.max_seq_len_tgt)
            item["tgtlen"] = np.asarray(b["tgt_sentence_lengths"], np.int32)
        if "ST" in self.mode or "ASR" in self.mode:
            if with_acous:
                norm = (self.load_mu_std(b["acous_spkids"])
                        if self.acous_norm else None)
                item["acous_feat"] = self.load_acous(
                    b["acous_flis"], norm_param=norm,
                    lengths=b["acous_lengths"]
                )
            else:
                item["_flis"] = list(b["acous_flis"])
            item["acouslen"] = np.asarray(b["acous_lengths"], np.int32)
        return item

    def iter_batches(self, with_acous: bool = True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self.batches)):
            yield self.materialise_batch(i, with_acous=with_acous)


def load_pretrained_embedding(word2id, embedding_matrix, embedding_path):
    """Overlay pretrained word vectors (ref: dataset.py:631-651)."""
    counter = 0
    with open(embedding_path, encoding="UTF-8") as f:
        for line in f:
            items = line.strip().split()
            if len(items) <= 2:
                continue
            word = items[0].lower()
            if word in word2id:
                wid = word2id[word]
                embedding_matrix[wid] = np.asarray(items[1:], dtype=np.float64)
                counter += 1
    print("loaded pre-trained embedding:", embedding_path)
    print("embedding vectors found:", counter)
    return embedding_matrix
