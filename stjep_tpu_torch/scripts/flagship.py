"""The flagship workload of the measurement scripts (chip_smoke.py,
scripts/profile_decode.py): bench.py's ASR_ST model (bench.py:24-38,
120-129), its shapes and inputs made from a seed, and a corpus in the
reference layout."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

FLAGSHIP = dict(
    enc_vocab_size=30000, dec_vocab_size=200, enc_embedding_size=200,
    dec_embedding_size=512, acous_dim=40, acous_hidden_size=256,
    dim_model=512, dim_feedforward=1024, num_heads=8, enc_layers=6,
    dec_layers=6, num_unilstm_dec=3, spec_aug=True, dropout=0.2,
    max_seq_len_src=90, max_seq_len_tgt=150, mode="ASR_ST")
B, FRAMES, DECODE_LEN, BEAM = 16, 1504, 150, 5
TRAIN_LR = 1e-4  # bench.py's train row
SPECIALS = ["<pad>", "<unk>", "<s>", "</s>", "<spc>"]
SPEAKERS = 4
CORPUS_FRAMES = (400, 1504)  # a corpus utterance's frames, low and high
CORPUS_UTTS = {"train": 64, "dev": 16}  # write_corpus's utterances a split for the CLI runs


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def train_flags():
    """train.py's flags for FLAGSHIP's model, f32, B = 16: its widths and
    bench's train settings (dropout, TRAIN_LR constant from step 0), a
    line every 2 steps, no device cache. Callers add the mode, the data,
    the epochs, the checkpoint interval and what else their run needs."""
    f = FLAGSHIP
    return [
        "--embedding_size_enc", str(f["enc_embedding_size"]),
        "--embedding_size_dec", str(f["dec_embedding_size"]),
        "--dim_model", str(f["dim_model"]), "--dim_feedforward", str(f["dim_feedforward"]),
        "--num_heads", str(f["num_heads"]), "--enc_layers", str(f["enc_layers"]),
        "--dec_layers", str(f["dec_layers"]), "--las_acous_dim", str(f["acous_dim"]),
        "--las_acous_hidden_size", str(f["acous_hidden_size"]),
        "--max_seq_len_src", str(f["max_seq_len_src"]),
        "--max_seq_len_tgt", str(f["max_seq_len_tgt"]), "--batch_size", str(B),
        "--minibatch_partition", "1", "--dropout", str(f["dropout"]),
        "--learning_rate", str(TRAIN_LR), "--learning_rate_init", str(TRAIN_LR),
        "--lr_warmup_steps", "0", "--print_every", "2", "--device_cache", "False"]


def inputs(rng, n):
    """Seeded fbank-shaped features and lengths, as bench.py makes them."""
    feats = rng.randn(n, FRAMES, 40).astype(np.float32)
    lens = rng.randint(FRAMES // 2, FRAMES - 8, size=(n,)).astype(np.int64)
    lens[0] = FRAMES - 8  # round_up8(max) == FRAMES
    return torch.from_numpy(feats), torch.from_numpy(lens)


def train_batch(rng, cfg, n, frames):
    """bench.py's train inputs: fbank-shaped features with lengths in
    [frames/2, frames-8] (one at frames-8), random source and target ids."""
    feats = torch.from_numpy(rng.randn(n, frames, cfg.acous_dim).astype(np.float32))
    lens = torch.from_numpy(rng.randint(frames // 2, frames - 8, size=(n,)))
    lens[0] = frames - 8
    src = rng.randint(5, cfg.enc_vocab_size, (n, cfg.max_seq_len_src))
    tgt = rng.randint(5, cfg.dec_vocab_size, (n, cfg.max_seq_len_tgt))
    return {"srcid": torch.from_numpy(src), "tgtid": torch.from_numpy(tgt),
            "acous_feat": feats, "acouslen": lens}


def write_corpus(root: Path, seed: int, utts: dict, frames=CORPUS_FRAMES) -> dict:
    """A corpus in the reference layout: vocab files (the five specials,
    then 29 995 source words and 195 target characters: bench's 30 000 and
    200), src/tgt text, one 40-dim fbank .npy an utterance of `frames`
    (low, high) frames, an acoustic file list `path frames speaker`, and
    per-speaker CMVN stats. utts: utterances a split."""
    rng = np.random.RandomState(seed + 11)
    words = [f"w{i:05d}" for i in range(FLAGSHIP["enc_vocab_size"] - len(SPECIALS))]
    chars = [chr(0x4E00 + i) for i in range(FLAGSHIP["dec_vocab_size"] - len(SPECIALS))]
    (root / "fbk").mkdir(parents=True)
    (root / "norm").mkdir()
    (root / "vocab.src").write_text("\n".join(SPECIALS + words) + "\n", encoding="utf-8")
    (root / "vocab.tgt").write_text("\n".join(SPECIALS + chars) + "\n", encoding="utf-8")
    dim = FLAGSHIP["acous_dim"]
    for s_ in range(SPEAKERS):
        np.save(root / "norm" / f"spk{s_}.mu.npy", (rng.randn(dim) * 0.1).astype(np.float32))
        np.save(root / "norm" / f"spk{s_}.std.npy", (1.0 + 0.1 * rng.rand(dim)).astype(np.float32))
    paths = {"vocab_src": root / "vocab.src", "vocab_tgt": root / "vocab.tgt",
             "norm": root / "norm"}
    for split_, n in utts.items():
        src, tgt, flis = [], [], []
        for i in range(n):
            ids = rng.randint(0, len(words), rng.randint(3, 30))
            src.append(" ".join(words[w] for w in ids))
            tgt.append(" ".join("".join(chars[(w * 7 + k) % len(chars)]
                                        for k in range(1 + w % 3)) for w in ids))
            n_frames = rng.randint(frames[0], frames[1] + 1)
            f = root / "fbk" / f"{split_}_{i:03d}.npy"
            np.save(f, rng.randn(n_frames, dim).astype(np.float32))
            flis.append(f"{f} {n_frames} spk{i % SPEAKERS}.fbk")
        for ext, lines in (("src", src), ("tgt", tgt), ("flis", flis)):
            paths[f"{split_}_{ext}"] = root / f"{split_}.{ext}"
            paths[f"{split_}_{ext}"].write_text("\n".join(lines) + "\n", encoding="utf-8")
    return {k: str(v) for k, v in paths.items()}
