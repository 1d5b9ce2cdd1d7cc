"""Locality-aware node reordering (host numpy and scipy, run once per graph).

Counterpart of the JAX package's ``ops/reorder.py``, kept as the port's own
copy: the same functions, giving the same orders for the same inputs.

After a good ordering most edges of a community-structured graph satisfy
``|sender - receiver| <= W/2``, which is what the locality tier of
``prepare_graph`` needs: ``band_window=W`` stores those edges as a dense band
multiplied by row blocks (``kernels/band_cuda.py``), and ``attend_window=W``
lets the attention backward sum their sender cotangents window by window
without a permutation. Whether that beats the gather kernels on a given card
is a measurement, not a rule (``PERF.md``).

Two orderings: **hub + reverse Cuthill-McKee** (``hub_rcm_order``; the
``hub_k`` highest-degree nodes first, RCM on the rest) for mesh-like graphs,
and **label-propagation clusters** (``cluster_order``: LPA communities placed
along a greedy connectivity chain) for community graphs, where RCM's BFS
levels are destroyed by inter-community shortcut edges.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hub_rcm_order",
    "rcm_order",
    "degree_order",
    "cluster_order",
    "lpa_labels",
    "invert_order",
    "band_coverage",
]


def _sym_csr(senders, receivers, num_nodes):
    from scipy.sparse import csr_matrix

    s = np.asarray(senders)
    r = np.asarray(receivers)
    data = np.ones(2 * s.shape[0], np.int8)
    a = csr_matrix(
        (data, (np.concatenate([r, s]), np.concatenate([s, r]))),
        shape=(num_nodes, num_nodes),
    )
    a.data[:] = 1
    return a


def rcm_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee order of the symmetrized graph.

    Returns ``order`` such that ``order[k]`` is the old id of the node
    placed at new position ``k`` (scipy convention).
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = _sym_csr(senders, receivers, num_nodes)
    return np.asarray(
        reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int64
    )


def degree_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Nodes sorted by total degree, descending (stable)."""
    deg = np.bincount(
        np.asarray(receivers), minlength=num_nodes
    ) + np.bincount(np.asarray(senders), minlength=num_nodes)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def hub_rcm_order(
    senders,
    receivers,
    num_nodes: int,
    *,
    hub_k: int = 0,
) -> np.ndarray:
    """Hub-first + RCM-on-the-rest ordering (see module docstring).

    ``hub_k = 0`` is plain RCM. Hubs are the ``hub_k`` highest-degree
    nodes; they take new ids ``0..hub_k-1`` (degree-descending), and the
    remaining nodes are RCM-ordered on the subgraph with hubs removed.
    """
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    if hub_k <= 0:
        return rcm_order(s, r, num_nodes)
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    by_deg = degree_order(s, r, num_nodes)
    hubs = by_deg[:hub_k]
    is_hub = np.zeros(num_nodes, bool)
    is_hub[hubs] = True
    keep = ~(is_hub[s] | is_hub[r])
    rest_old = by_deg[hub_k:]
    # Compact the hub-free subgraph to [0, num_rest) ids for scipy.
    compact = np.full(num_nodes, -1, np.int64)
    compact[rest_old] = np.arange(rest_old.shape[0])
    a = _sym_csr(
        compact[s[keep]], compact[r[keep]], rest_old.shape[0]
    )
    sub = np.asarray(
        reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int64
    )
    return np.concatenate([hubs, rest_old[sub]])


def lpa_labels(
    senders,
    receivers,
    num_nodes: int,
    *,
    iters: int = 10,
    tol: float = 0.01,
) -> np.ndarray:
    """Label-propagation community labels (synchronous, vectorized).

    Each round every node adopts the modal label among its in-neighbors
    (computed with one O(E log E) sort + run-length count — no Python
    per-node loop); stops early when fewer than ``tol`` of nodes change.
    Pass a symmetrized edge list for undirected semantics.

    RCM is the wrong tool for community graphs (its BFS levels are
    destroyed by inter-community shortcut edges); LPA recovers the
    communities of a scrambled stochastic block model.
    """
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    for _ in range(iters):
        key = r * num_nodes + labels[s]
        key.sort()
        runs = np.flatnonzero(
            np.concatenate([[True], key[1:] != key[:-1]])
        )
        counts = np.diff(np.append(runs, key.shape[0]))
        rr = key[runs] // num_nodes
        lab = key[runs] % num_nodes
        # Per receiver keep the label with the max count (stable ties).
        by = np.lexsort((-counts, rr))
        rr2, lab2 = rr[by], lab[by]
        first = np.concatenate([[True], rr2[1:] != rr2[:-1]])
        new = labels.copy()
        new[rr2[first]] = lab2[first]
        changed = float(np.mean(new != labels))
        labels = new
        if changed < tol:
            break
    return labels


def _cluster_chain_rank(cs, cr, num_clusters, sizes) -> np.ndarray:
    """Greedy connectivity chain over the cluster graph: each next
    cluster is the heaviest-connected unvisited neighbor of the current
    one (fallback: largest remaining). Adjacent placement puts
    inter-cluster edges between chained clusters inside the band window
    too, which raises band coverage over first-seen cluster order."""
    from scipy.sparse import csr_matrix

    inter = cs != cr
    a = csr_matrix(
        (np.ones(int(inter.sum()), np.int64),
         (cs[inter], cr[inter])),
        shape=(num_clusters, num_clusters),
    )
    a = (a + a.T).tocsr()
    visited = np.zeros(num_clusters, bool)
    by_size = np.argsort(-sizes, kind="stable")
    size_ptr = 0
    rank = np.empty(num_clusters, np.int64)
    cur = int(by_size[0])
    for pos in range(num_clusters):
        visited[cur] = True
        rank[cur] = pos
        lo, hi = a.indptr[cur], a.indptr[cur + 1]
        nbrs = a.indices[lo:hi]
        wts = a.data[lo:hi]
        live = ~visited[nbrs]
        if live.any():
            sub = np.flatnonzero(live)
            cur = int(nbrs[sub[np.argmax(wts[sub])]])
            continue
        while size_ptr < num_clusters and visited[by_size[size_ptr]]:
            size_ptr += 1
        if size_ptr == num_clusters:
            break
        cur = int(by_size[size_ptr])
    return rank


def cluster_order(
    senders,
    receivers,
    num_nodes: int,
    *,
    iters: int = 25,
    tol: float = 0.002,
    chain: bool = True,
) -> np.ndarray:
    """Community-clustered node order: LPA labels, clusters placed along
    a greedy connectivity chain (``chain=False``: first-seen order),
    node ids ascending within each cluster.

    The workhorse ordering for the banded-dense SpMM tier on
    community-structured graphs: intra-community edges (the majority in
    real citation/social graphs) land within one band window, and the
    chain catches much of the inter-community mass too.
    """
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    labels = lpa_labels(s, r, num_nodes, iters=iters, tol=tol)
    _, cl = np.unique(labels, return_inverse=True)
    if chain:
        sizes = np.bincount(cl)
        rank = _cluster_chain_rank(cl[s], cl[r], cl.max() + 1, sizes)
        key = rank[cl]
    else:
        key = cl
    return np.lexsort((np.arange(num_nodes), key)).astype(np.int64)


def invert_order(order: np.ndarray) -> np.ndarray:
    """old-id -> new-id map from an ``order`` (new-position -> old-id)."""
    inv = np.empty(order.shape[0], np.int64)
    inv[order] = np.arange(order.shape[0])
    return inv


def band_coverage(
    senders, receivers, *, windows=(512, 1024, 2048, 4096), hot_k: int = 0
) -> dict[int, float]:
    """Fraction of edges with ``|s - r| <= w/2`` (or sender < hot_k) per
    window width — the payoff metric for an ordering."""
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    d = np.abs(s - r)
    hot = s < hot_k
    return {
        int(w): float(np.mean(hot | (d <= w // 2))) for w in windows
    }
