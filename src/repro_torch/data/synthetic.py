"""Deterministic synthetic datasets.

* ``cifarlike_dataset`` — class-conditional Gaussian images (32x32x3, 10
  classes) standing in for CIFAR-10 (not available offline). LeNet-5 learns
  it the same qualitative way; scheme-to-scheme convergence *ratios* (the
  paper's claim) are preserved.
* ``synthetic_tokens`` — structured token streams for LM smoke training: a
  noisy order-2 Markov chain so cross-entropy measurably falls below the
  uniform baseline.
* ``dirichlet_partition`` — standard non-IID federated split.
"""
from __future__ import annotations

import numpy as np


def cifarlike_dataset(n: int = 10000, num_classes: int = 10, image_size: int = 32,
                      channels: int = 3, noise: float = 0.35, seed: int = 0,
                      template_seed: int = 1234):
    """Returns (images (n,H,W,C) float32 in [-1,1]-ish, labels (n,) int32).

    Class templates come from ``template_seed`` (FIXED across train/test
    splits — the templates ARE the class definitions); only the sample
    noise and the label draw vary with ``seed``."""
    trng = np.random.default_rng(template_seed)
    rng = np.random.default_rng(seed)
    # class templates: low-frequency random patterns (so convs help)
    freq = 4
    coarse = trng.normal(0, 1, (num_classes, freq, freq, channels))
    templates = np.stack([
        np.kron(coarse[c], np.ones((image_size // freq, image_size // freq, 1)))
        for c in range(num_classes)])                       # (10,H,W,C)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = templates[labels] + noise * rng.normal(0, 1, (n, image_size, image_size, channels))
    return images.astype(np.float32), labels


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 1.0,
                        seed: int = 0):
    """Non-IID split: per-class Dirichlet proportions. Returns list of index
    arrays (one per client)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shards: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            shards[cid].extend(part.tolist())
    return [np.array(sorted(s), dtype=np.int64) for s in shards]


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0,
                     order: int = 2, noise: float = 0.1):
    """Noisy deterministic-Markov token stream: next = (a*prev + b*prev2) % V
    with probability (1-noise), uniform otherwise. Learnable structure."""
    rng = np.random.default_rng(seed)
    a, b = 31, 17
    out = np.empty(n_tokens, np.int32)
    out[0], out[1] = rng.integers(0, vocab, 2)
    noise_mask = rng.random(n_tokens) < noise
    noise_tok = rng.integers(0, vocab, n_tokens)
    for i in range(order, n_tokens):
        out[i] = noise_tok[i] if noise_mask[i] else (a * out[i - 1] + b * out[i - 2] + 7) % vocab
    return out


def token_batches(stream: np.ndarray, batch: int, seq: int, n_batches: int,
                  seed: int = 0):
    """Yield {"tokens","labels"} batches from a stream (next-token labels)."""
    rng = np.random.default_rng(seed)
    max_start = len(stream) - seq - 1
    for _ in range(n_batches):
        starts = rng.integers(0, max_start, batch)
        toks = np.stack([stream[s: s + seq] for s in starts])
        labs = np.stack([stream[s + 1: s + seq + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32), "labels": labs.astype(np.int32)}
