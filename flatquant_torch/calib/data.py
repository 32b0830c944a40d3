"""Calibration / evaluation data loaders (port of
flatquant_tpu/calib/data.py, numpy only: the same seed gives the same
tokens, draw for draw).

Parity target: flatquant/data_utils.py:12-108 (WikiText2 / C4 / PTB / Pile;
train mode = nsamples random seqlen-token crops, eval mode = full
concatenated test tokenization).

This environment may have zero network egress, so every loader degrades to
a deterministic synthetic corpus (`synthetic`): a seeded order-1 Markov
chain over the model vocab with Zipf-ish marginals — structured enough for
calibration losses and PPL self-consistency tests to be meaningful, with no
downloads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CalibData:
    train: np.ndarray  # [nsamples, seqlen] int32
    test: np.ndarray  # [1, n_test_tokens] int32
    source: str


def synthetic_stream(vocab_size: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Seeded Markov-chain token stream with Zipfian unigram marginals."""
    rng = np.random.default_rng(seed)
    v = int(vocab_size)
    # Zipf marginals
    ranks = np.arange(1, v + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    # sparse transition structure: each token prefers a small successor set
    n_succ = min(32, v)
    succ = rng.integers(0, v, size=(v, n_succ))
    out = np.empty(n_tokens, np.int32)
    tok = int(rng.integers(0, v))
    unigram_draws = rng.choice(v, size=n_tokens, p=probs)
    mix = rng.random(n_tokens)
    succ_idx = rng.integers(0, n_succ, size=n_tokens)
    for i in range(n_tokens):
        if mix[i] < 0.7:
            tok = int(succ[tok, succ_idx[i]])
        else:
            tok = int(unigram_draws[i])
        out[i] = tok
    return out


def _crops(stream: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(stream) - seqlen - 1, size=nsamples)
    return np.stack([stream[s : s + seqlen] for s in starts]).astype(np.int32)


def _try_hf_text(name: str, split: str) -> Optional[str]:
    """Load raw text from HF datasets if the cache/network allows."""
    try:
        from datasets import load_dataset

        if name == "wikitext2":
            ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
            return "\n\n".join(ds["text"])
        if name == "c4":
            ds = load_dataset(
                "allenai/c4",
                data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
                split="validation",
            )
            return " ".join(ds["text"][:2000])
        if name == "ptb":
            ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
            return " ".join(ds["sentence"])
        if name == "pile":
            ds = load_dataset(
                "mit-han-lab/pile-val-backup", split="validation"
            )
            return " ".join(ds["text"][:2000])
    except Exception:
        return None
    return None


def _local_text(path: str) -> str:
    """Raw text from a LOCAL corpus file — .txt (verbatim), .jsonl
    (one {"text": ...} object per line) or .json (list of strings /
    {"text": ...} objects). The zero-egress answer to the reference's
    HF-hub loaders (data_utils.py): pre-downloaded corpora drive the
    same tokenize -> crop -> eval-stream pipeline."""
    import json as _json

    with open(path, "r", encoding="utf-8") as fh:
        if path.endswith(".jsonl"):
            rows = [_json.loads(ln) for ln in fh if ln.strip()]
            return "\n\n".join(r["text"] if isinstance(r, dict) else str(r)
                               for r in rows)
        if path.endswith(".json"):
            rows = _json.load(fh)
            return "\n\n".join(r["text"] if isinstance(r, dict) else str(r)
                               for r in rows)
        return fh.read()


def get_loaders(
    name: str,
    vocab_size: int,
    nsamples: int = 128,
    seqlen: int = 2048,
    seed: int = 0,
    tokenizer=None,
    n_test_tokens: int = 256 * 2048,
) -> CalibData:
    """Return calibration crops + eval stream.

    name in {wikitext2, c4, ptb, pile, synthetic}, or a PATH to a local
    corpus file (.txt / .jsonl / .json — needs a tokenizer; the first
    90% of the token stream yields the calibration crops, the last 10%
    the held-out eval stream). Hub datasets require a tokenizer +
    network/cache; otherwise falls back to `synthetic`.
    """
    import os as _os

    if tokenizer is not None and _os.path.isfile(name):
        ids = np.asarray(tokenizer(_local_text(name)).input_ids, np.int32)
        cut = max(int(len(ids) * 0.9), len(ids) - n_test_tokens)
        train_ids, test_ids = ids[:cut], ids[cut:]
        return CalibData(
            train=_crops(train_ids, nsamples, seqlen, seed),
            test=test_ids[None, :n_test_tokens],
            source=_os.path.basename(name),
        )
    if name != "synthetic" and tokenizer is not None:
        split = "test" if name != "c4" else "validation"
        text = _try_hf_text(name, split)
        train_text = _try_hf_text(name, "train")
        if text is not None and train_text is not None:
            test_ids = np.asarray(tokenizer(text).input_ids, np.int32)[None, :]
            train_ids = np.asarray(tokenizer(train_text).input_ids, np.int32)
            return CalibData(
                train=_crops(train_ids, nsamples, seqlen, seed),
                test=test_ids[:, : n_test_tokens],
                source=name,
            )
    # synthetic fallback
    stream = synthetic_stream(vocab_size, max(n_test_tokens, nsamples * (seqlen + 1) * 2), seed)
    train = _crops(stream, nsamples, seqlen, seed + 1)
    test_stream = synthetic_stream(vocab_size, n_test_tokens, seed + 1234)
    return CalibData(train=train, test=test_stream[None, :], source="synthetic")
