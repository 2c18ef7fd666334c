"""Non-IID synthetic token streams for federated clients, vectorized.

The semantics of ``repro_torch/data/lm.py::federated_token_clients``
(copied here so that the yardstick cannot move with the program): client
c follows domain ``c % domains``'s Markov chain, in which every token
maps to one of ``hubs`` hubs and a hub to ``successors`` next tokens,
drawn uniformly; with probability ``restart_p`` a step restarts from a
zipf marginal (p ~ 1 / rank) over the vocabulary.  A domain's chain is
fixed by the domain alone, so the same domain has the same structure in
every run, and a client's walk is drawn from ``(seed, client)``.

Where the program's version draws one token at a time (a Python loop
with an O(vocab) draw at each restart), this one draws every restart and
every successor choice at once and walks all the runs between restarts
together, one step of every run at a time: as many numpy steps as the
longest run (~100 at restart_p 0.1), not as many as tokens.  The draws
differ from the program's; the distribution is the same.
"""
from __future__ import annotations

from typing import List

import numpy as np

# the domain chains' own seed, beside the domain index
DOMAIN_SEED = 0x5EED


def domain_chain(vocab: int, domain: int, hubs: int, successors: int):
    """(hub of each token (vocab,), the successors of each hub (hubs,
    successors))."""
    rng = np.random.default_rng([DOMAIN_SEED, domain])
    return (rng.integers(0, hubs, size=vocab),
            rng.integers(0, vocab, size=(hubs, successors)))


def zipf_draws(rng, vocab: int, n: int) -> np.ndarray:
    """n draws from p(rank) ~ 1 / rank over ``vocab`` tokens, by the
    inverse of its distribution function."""
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1))
    u = rng.uniform(0.0, cdf[-1], size=n)
    return np.minimum(np.searchsorted(cdf, u, side="right"), vocab - 1)


def client_stream(vocab: int, length: int, chain, rng, restart_p: float
                  ) -> np.ndarray:
    """One client's ``length`` tokens (int32)."""
    hub_of, hub_next = chain
    # position 0 starts a run; each later position restarts with restart_p
    starts = np.flatnonzero(np.concatenate(
        [[True], rng.uniform(size=length - 1) < restart_p]))
    pick = rng.integers(0, hub_next.shape[1], size=length)
    toks = np.empty(length, np.int64)
    toks[starts] = zipf_draws(rng, vocab, len(starts))
    ends = np.append(starts[1:], length)
    run_len = ends - starts
    for k in range(1, int(run_len.max())):
        alive = run_len > k
        pos = starts[alive] + k
        toks[pos] = hub_next[hub_of[toks[pos - 1]], pick[pos]]
    return toks.astype(np.int32)


def client_streams(vocab: int, mix: dict, seed: int) -> List[np.ndarray]:
    """The mix's clients' streams: ``clients`` streams of
    ``tokens_per_client`` tokens over ``domains`` domains."""
    chains = {}
    out = []
    for c in range(mix["clients"]):
        dom = c % mix["domains"]
        if dom not in chains:
            chains[dom] = domain_chain(vocab, dom, mix["hubs"],
                                       mix["successors"])
        rng = np.random.default_rng([seed, c])
        out.append(client_stream(vocab, mix["tokens_per_client"],
                                 chains[dom], rng, mix["restart_p"]))
    return out
