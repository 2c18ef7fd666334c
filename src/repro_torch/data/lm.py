"""Synthetic language-model token streams for the federated-LLM scenario.

Per-client non-IID structure: every client draws from a mixture of "domain"
Markov chains over the vocabulary (zipf-ish marginals, domain-specific
bigram structure), so client gradients are dissimilar — the V-dissimilarity
regime of the paper's Assumption 2.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


def _domain_chain(rng, vocab: int, n_hubs: int = 64):
    """Cheap structured bigram sampler: each token maps to a 'hub' whose
    successor distribution is domain-specific."""
    hub_of = rng.integers(0, n_hubs, size=vocab)
    hub_next = rng.integers(0, vocab, size=(n_hubs, 8))  # 8 successors per hub
    return hub_of, hub_next


def synthetic_token_stream(vocab: int, length: int, *, domain_seed: int = 0,
                           seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    drng = np.random.default_rng(domain_seed)
    hub_of, hub_next = _domain_chain(drng, vocab)
    # zipf marginal for restarts
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks
    p /= p.sum()
    toks = np.empty(length, np.int32)
    cur = int(rng.choice(vocab, p=p))
    for i in range(length):
        toks[i] = cur
        if rng.uniform() < 0.1:  # restart from the marginal
            cur = int(rng.choice(vocab, p=p))
        else:
            cur = int(hub_next[hub_of[cur], rng.integers(0, 8)])
    return toks


def federated_token_clients(n_clients: int, vocab: int, tokens_per_client: int,
                            n_domains: int = 4, seed: int = 0
                            ) -> List[np.ndarray]:
    """Each client = one dominant domain + a little mixing (non-IID)."""
    out = []
    for c in range(n_clients):
        dom = c % n_domains
        out.append(
            synthetic_token_stream(
                vocab, tokens_per_client, domain_seed=dom, seed=seed * 97 + c
            )
        )
    return out


def batches_from_tokens(tokens: np.ndarray, batch: int, seq: int, seed: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, max(n, 1), size=batch)
        x = np.stack([tokens[s : s + seq] for s in starts])
        y = np.stack([tokens[s + 1 : s + seq + 1] for s in starts])
        yield {"tokens": x.astype(np.int32), "labels": y.astype(np.int32)}
