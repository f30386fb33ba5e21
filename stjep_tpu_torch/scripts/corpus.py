"""The synthetic corpora of the port's end-to-end scripts (a copy of
tests/data_factory.py, which imports no JAX; tests/test_torch_recipe.py pins
the two byte-equal on disk).

make_corpus is run_full_recipe.sh's tiny 24-sentence corpus; make_hard_corpus
is the quality run's corpus (homophone pairs plant a WER floor). Both write
the reference's on-disk layout (ref: utils/dataset.py): vocab files with the
special tokens on lines 0-4, src/tgt text files, per-utterance fbank .npy
files, an acoustic file list of `path length spkid` lines, and per-speaker
CMVN stats.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

SPECIALS = ["<pad>", "<unk>", "<s>", "</s>", "<spc>"]

SRC_WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast", "home",
             "bird", "sang", "loud", "tree", "sky", "blue"]
TGT_CHARS = list("abcdefghij")


# --- hard (non-saturating) corpus -----------------------------------------
# A quality gate on the easy corpus saturated (dev WER 0.000 / BLEU 1.000), so it
# could not see a regression that "only" costs quality. This corpus plants a
# model-independent error floor: HARD_N_PAIRS homophone pairs share one
# acoustic prototype, words are drawn i.i.d. (context carries no signal), so
# even a Bayes-optimal recogniser gets ~50% of ambiguous tokens wrong:
#   floor WER ~= (2*HARD_N_PAIRS / n_words) * 0.5
# (0.25 with the defaults) and char-level ST BLEU lands well below 1.0.
# Mid-range metrics move when training is subtly wrong (loss coeffs, LR
# formula, dropout placement) — that is what the gate needs to detect.
#
# Design note (measured): the floor must come from AMBIGUITY, not
# from marginal learnability. An earlier variant (40 words, noise 0.45) sat
# on a learning cliff — the torch reference never escaped its plateau and
# even a healthy run's WER depended on whether training "broke through" in
# time, which makes a gate seed-sensitive. With the easy corpus's scale
# (16 words, noise 0.3) both frameworks reliably saturate LEARNING and the
# dev metrics settle at the homophone floor — reproducible mid-range.
HARD_N_WORDS = 16
HARD_N_PAIRS = 4


def make_hard_corpus(
    root: str,
    n_sent: int = 360,
    acous_dim: int = 8,
    min_words: int = 2,
    max_words: int = 5,
    frames_per_word: int = 12,
    n_speakers: int = 3,
    seed: int = 0,
    noise: float = 0.3,
    prefix: str = "train",
):
    """Learnable-but-ambiguous ST corpus (same on-disk layout as make_corpus).

    Words w00..w39; w(2i)/w(2i+1) for i<HARD_N_PAIRS are homophones (same
    acoustic prototype). Each word maps to a unique 2-char target drawn from
    a seeded shuffle, so translation errors mirror recognition errors."""
    rng = np.random.RandomState(seed)
    words = [f"w{i:02d}" for i in range(HARD_N_WORDS)]

    proto_rng = np.random.RandomState(4321)  # corpus-stable prototypes
    protos = {}
    for i, w in enumerate(words):
        if i < 2 * HARD_N_PAIRS and i % 2 == 1:
            protos[w] = protos[words[i - 1]]  # homophone of its pair mate
        else:
            protos[w] = proto_rng.randn(
                frames_per_word, acous_dim).astype(np.float32)

    combos = [a + b for a in TGT_CHARS for b in TGT_CHARS]
    np.random.RandomState(99).shuffle(combos)
    word_map = {w: combos[i] for i, w in enumerate(words)}

    os.makedirs(root, exist_ok=True)
    feadir = join(root, "fbk")
    normdir = join(root, "norm")
    os.makedirs(feadir, exist_ok=True)
    os.makedirs(normdir, exist_ok=True)

    vocab_src = SPECIALS + words
    vocab_tgt = SPECIALS + TGT_CHARS
    with open(join(root, "vocab.src"), "w") as f:
        f.write("\n".join(vocab_src) + "\n")
    with open(join(root, "vocab.tgt"), "w") as f:
        f.write("\n".join(vocab_tgt) + "\n")

    for s in range(n_speakers):
        np.save(join(normdir, f"spk{s}.mu.npy"),
                rng.randn(acous_dim).astype(np.float32) * 0.1)
        np.save(join(normdir, f"spk{s}.std.npy"),
                (1.0 + 0.1 * rng.rand(acous_dim)).astype(np.float32))

    src_lines, tgt_lines, flis_lines = [], [], []
    for i in range(n_sent):
        nw = rng.randint(min_words, max_words + 1)
        sent = [words[rng.randint(len(words))] for _ in range(nw)]
        src_lines.append(" ".join(sent))
        tgt_lines.append(" ".join(word_map[w] for w in sent))
        feat = np.concatenate([protos[w] for w in sent], axis=0)
        feat = feat + noise * rng.randn(*feat.shape).astype(np.float32)
        fpath = join(feadir, f"{prefix}_utt{i:04d}.npy")
        np.save(fpath, feat)
        spk = f"spk{i % n_speakers}"
        flis_lines.append(f"{fpath} {feat.shape[0]} {spk}.extra")

    with open(join(root, f"{prefix}.src"), "w") as f:
        f.write("\n".join(src_lines) + "\n")
    with open(join(root, f"{prefix}.tgt"), "w") as f:
        f.write("\n".join(tgt_lines) + "\n")
    with open(join(root, f"{prefix}.flis"), "w") as f:
        f.write("\n".join(flis_lines) + "\n")

    return {
        "root": root,
        "path_src": join(root, f"{prefix}.src"),
        "path_tgt": join(root, f"{prefix}.tgt"),
        "path_vocab_src": join(root, "vocab.src"),
        "path_vocab_tgt": join(root, "vocab.tgt"),
        "acous_path": join(root, f"{prefix}.flis"),
        "acous_norm_path": normdir,
        "acous_dim": acous_dim,
        "vocab_src_size": len(vocab_src),
        "vocab_tgt_size": len(vocab_tgt),
    }


def make_corpus(
    root: str,
    n_sent: int = 24,
    acous_dim: int = 8,
    min_words: int = 2,
    max_words: int = 5,
    frames_per_word: int = 12,
    n_speakers: int = 3,
    seed: int = 0,
    learnable: bool = False,
    noise: float = 0.3,
    prefix: str = "train",
):
    """Create a tiny ST-style corpus under `root`. Returns a dict of paths.

    learnable=True makes the task solvable: each word has a fixed random
    acoustic prototype (frames_per_word x acous_dim) and utterances are the
    concatenated prototypes + N(0, noise) — so ASR/ST quality measured on it
    reflects real model learning, not chance. The word -> chars mapping is
    seeded (not Python hash) so src/tgt pairs are reproducible across runs."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(1234)  # word prototypes: corpus-stable
    protos = {
        w: proto_rng.randn(frames_per_word, acous_dim).astype(np.float32)
        for w in SRC_WORDS
    }
    word_map = {
        w: "".join(TGT_CHARS[(i * 3 + k) % len(TGT_CHARS)] for k in range(2))
        for i, w in enumerate(SRC_WORDS)
    }
    os.makedirs(root, exist_ok=True)
    feadir = join(root, "fbk")
    normdir = join(root, "norm")
    os.makedirs(feadir, exist_ok=True)
    os.makedirs(normdir, exist_ok=True)

    vocab_src = SPECIALS + SRC_WORDS
    vocab_tgt = SPECIALS + TGT_CHARS
    with open(join(root, "vocab.src"), "w") as f:
        f.write("\n".join(vocab_src) + "\n")
    with open(join(root, "vocab.tgt"), "w") as f:
        f.write("\n".join(vocab_tgt) + "\n")

    # per-speaker CMVN stats
    for s in range(n_speakers):
        np.save(join(normdir, f"spk{s}.mu.npy"),
                rng.randn(acous_dim).astype(np.float32) * 0.1)
        np.save(join(normdir, f"spk{s}.std.npy"),
                (1.0 + 0.1 * rng.rand(acous_dim)).astype(np.float32))

    src_lines, tgt_lines, flis_lines = [], [], []
    for i in range(n_sent):
        nw = rng.randint(min_words, max_words + 1)
        words = [SRC_WORDS[rng.randint(len(SRC_WORDS))] for _ in range(nw)]
        src_lines.append(" ".join(words))
        if learnable:
            chars = [word_map[w] for w in words]
        else:
            # tgt: "translate" each word to 2 chars (per-process mapping)
            chars = ["".join(
                TGT_CHARS[(hash(w) + k) % len(TGT_CHARS)] for k in range(2))
                for w in words]
        tgt_lines.append(" ".join(chars))

        if learnable:
            feat = np.concatenate([protos[w] for w in words], axis=0)
            feat = feat + noise * rng.randn(*feat.shape).astype(np.float32)
            T = feat.shape[0]
        else:
            T = nw * frames_per_word + int(rng.randint(0, 7))
            feat = rng.randn(T, acous_dim).astype(np.float32)
        fpath = join(feadir, f"{prefix}_utt{i:04d}.npy")
        np.save(fpath, feat)
        spk = f"spk{i % n_speakers}"
        flis_lines.append(f"{fpath} {T} {spk}.extra")

    with open(join(root, f"{prefix}.src"), "w") as f:
        f.write("\n".join(src_lines) + "\n")
    with open(join(root, f"{prefix}.tgt"), "w") as f:
        f.write("\n".join(tgt_lines) + "\n")
    with open(join(root, f"{prefix}.flis"), "w") as f:
        f.write("\n".join(flis_lines) + "\n")

    return {
        "root": root,
        "path_src": join(root, f"{prefix}.src"),
        "path_tgt": join(root, f"{prefix}.tgt"),
        "path_vocab_src": join(root, "vocab.src"),
        "path_vocab_tgt": join(root, "vocab.tgt"),
        "acous_path": join(root, f"{prefix}.flis"),
        "acous_norm_path": normdir,
        "acous_dim": acous_dim,
        "vocab_src_size": len(vocab_src),
        "vocab_tgt_size": len(vocab_tgt),
    }
