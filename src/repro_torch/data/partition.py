"""Federated data partitioning: IID and Dirichlet(α) non-IID label skew.

Matches the paper's setup: RQ2-A uses a Dirichlet(α=0.5) non-IID partition
of CIFAR-100; RQ1 uses IID (|D_k| = 2,500 per client). Index arrays and
histograms are numpy, on the reference's PCG64 streams, so every partition
equals the reference's.
"""
from __future__ import annotations

import numpy as np


def iid_partition(n_items: int, n_clients: int, seed: int = 0
                  ) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_items)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 1
                        ) -> list[np.ndarray]:
    """Label-skewed partition: for each class, split its items across
    clients with proportions ~ Dirichlet(alpha). Lower alpha = more skew."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    buckets: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for b, part in zip(buckets, np.split(idx, cuts)):
            b.extend(part.tolist())
    # guarantee a minimum per client by stealing from the largest
    for b in buckets:
        while len(b) < min_per_client:
            donor = int(np.argmax([len(x) for x in buckets]))
            b.append(buckets[donor].pop())
    return [np.sort(np.asarray(b, dtype=np.int64)) for b in buckets]


def client_label_histogram(labels: np.ndarray,
                           parts: list[np.ndarray]) -> np.ndarray:
    classes = np.unique(labels)
    hist = np.zeros((len(parts), len(classes)), np.int64)
    for i, p in enumerate(parts):
        for j, c in enumerate(classes):
            hist[i, j] = int(np.sum(labels[p] == c))
    return hist
