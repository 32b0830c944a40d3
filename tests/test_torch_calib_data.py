"""The port's calibration data (flatquant_torch/calib/data.py) against
the JAX package's, on the CPU: token for token (both draw from numpy's
default_rng in the same order; no tolerance)."""

import json

import numpy as np
import pytest

from flatquant_tpu.calib import data as jd
from flatquant_torch.calib import data as td


class _StubTokenizer:
    """A deterministic stand-in for an HF tokenizer: one id per byte."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text):
        return self._Out([b % 97 for b in text.encode("utf-8")])


def _equal(a, b):
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.test, b.test)
    assert a.source == b.source
    assert a.train.dtype == b.train.dtype == np.int32


@pytest.mark.parametrize("vocab,n,seed", [(256, 5000, 0), (32000, 3000, 7),
                                          (20, 1000, 3)])
def test_synthetic_stream_equal(vocab, n, seed):
    np.testing.assert_array_equal(td.synthetic_stream(vocab, n, seed),
                                  jd.synthetic_stream(vocab, n, seed))


@pytest.mark.parametrize("name", ["synthetic", "wikitext2"])
def test_get_loaders_synthetic_equal(name):
    """The synthetic corpus, and a hub name without a tokenizer (falls
    back to it)."""
    kw = dict(nsamples=6, seqlen=32, seed=5, n_test_tokens=4096)
    _equal(td.get_loaders(name, 512, **kw), jd.get_loaders(name, 512, **kw))


@pytest.mark.parametrize("ext", [".txt", ".jsonl", ".json"])
def test_get_loaders_local_file_equal(tmp_path, ext):
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{int(i)}" for i in rng.integers(0, 50, 300))
            for _ in range(8)]
    path = tmp_path / f"corpus{ext}"
    if ext == ".txt":
        path.write_text("\n\n".join(docs))
    elif ext == ".jsonl":
        path.write_text("\n".join(json.dumps({"text": d}) for d in docs))
    else:
        path.write_text(json.dumps([{"text": d} for d in docs[:4]]
                                   + docs[4:]))
    kw = dict(nsamples=4, seqlen=64, seed=1, tokenizer=_StubTokenizer(),
              n_test_tokens=500)
    got = td.get_loaders(str(path), 97, **kw)
    _equal(got, jd.get_loaders(str(path), 97, **kw))
    assert got.source == path.name and got.test.shape == (1, 500)
