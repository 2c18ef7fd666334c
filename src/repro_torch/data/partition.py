"""Non-IID partitioners (for pooled datasets and the LLM token streams)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.3,
                        seed: int = 0) -> List[np.ndarray]:
    """Classic Dirichlet(alpha) label-skew partition -> index lists."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for idx in idx_by_class:
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    return [np.array(sorted(ix), dtype=np.int64) for ix in client_idx]


def label_sorted_partition(labels: np.ndarray, n_clients: int,
                           shards_per_client: int = 2, seed: int = 0
                           ) -> List[np.ndarray]:
    """McMahan-style pathological non-IID: sort by label, deal shards."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_clients * shards_per_client)
    ids = rng.permutation(len(shards))
    out = []
    for c in range(n_clients):
        take = ids[c * shards_per_client : (c + 1) * shards_per_client]
        out.append(np.concatenate([shards[i] for i in take]))
    return out
