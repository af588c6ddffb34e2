"""The one traffic generator: a language-model corpus described by a
traffic file (``bench/traffic/<name>.json``).

The stream is a seeded zipfian token sequence with a fixed n-gram rule,
cut into shards; a batch is ``batch`` rows of ``seq + 1`` consecutive
tokens (inputs and labels shifted by one), batch i being tokens
``[i * batch * (seq + 1), (i + 1) * batch * (seq + 1))`` of the stream.
``Corpus`` is handed to the program's loader (``load_shard`` is all it
reads); :func:`global_batch` cuts the same rows for the reference without
the program.  The corpus is a copy of the program's ``SyntheticCorpus``
with its constants read from the traffic file, so the traffic is the
benchmark's and not the program's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class Corpus:
    """Deterministic zipfian token shards of ``traffic["shard_tokens"]``."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.shard_tokens = int(traffic["shard_tokens"])
        self.zipf_a = float(traffic["zipf_a"])
        self.period = int(traffic["ngram_period"])
        self.mult = int(traffic["ngram_mult"])
        self.add = int(traffic["ngram_add"])

    def load_shard(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + idx)
        toks = (rng.zipf(self.zipf_a, size=self.shard_tokens)
                % self.vocab).astype(np.int32)
        p = self.period
        toks[1::p] = (toks[::p][: len(toks[1::p])] * self.mult
                      + self.add) % self.vocab
        return toks


def global_batch(corpus: Corpus, batch: int, seq: int, i: int):
    """(tokens, labels), each (batch, seq) int64 numpy, of batch ``i``."""
    need = batch * (seq + 1)
    lo, hi = i * need, (i + 1) * need
    first, last = lo // corpus.shard_tokens, (hi - 1) // corpus.shard_tokens
    stream = np.concatenate([corpus.load_shard(k)
                             for k in range(first, last + 1)])
    off = lo - first * corpus.shard_tokens
    rows = stream[off: off + need].reshape(batch, seq + 1).astype(np.int64)
    return rows[:, :-1], rows[:, 1:]
