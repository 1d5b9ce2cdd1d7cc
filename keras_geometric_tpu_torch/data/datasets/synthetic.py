"""Synthetic graph generators for tests and benchmarks.

Counterpart of the JAX package's ``data/datasets/synthetic.py``: deterministic
random graphs with the shape profile (node / edge / feature / class counts) of
the datasets they stand in for, so the full train / eval path runs without a
download. Every generator draws the same random numbers in the same order as
the reference's, so a seed gives the same arrays, bit for bit.
"""

from __future__ import annotations

import numpy as np

from ...utils.data_utils import GraphData

__all__ = [
    "synthetic_graph",
    "synthetic_planetoid",
    "rmat_edges",
    "community_graph",
    "PLANETOID_STATS",
]

# (num_nodes, num_directed_edges, num_features, num_classes) of the Planetoid
# datasets.
PLANETOID_STATS = {
    "cora": (2708, 10858, 1433, 7),
    "citeseer": (3327, 9464, 3703, 6),
    "pubmed": (19717, 88676, 500, 3),
}


def synthetic_graph(
    num_nodes: int,
    num_edges: int,
    num_features: int,
    *,
    num_classes: int | None = None,
    seed: int = 0,
    symmetric: bool = True,
    dtype=np.float32,
) -> GraphData:
    """Uniform random graph with optional symmetric (undirected) edges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_nodes, num_features)).astype(dtype)
    e = num_edges // 2 if symmetric else num_edges
    senders = rng.integers(0, num_nodes, size=e, dtype=np.int64)
    receivers = rng.integers(0, num_nodes, size=e, dtype=np.int64)
    if symmetric:
        s = np.concatenate([senders, receivers])
        r = np.concatenate([receivers, senders])
    else:
        s, r = senders, receivers
    edge_index = np.stack([s, r]).astype(np.int32)
    y = None
    if num_classes is not None:
        y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return GraphData(x=x, edge_index=edge_index, y=y)


def synthetic_planetoid(name: str = "cora", seed: int = 0) -> GraphData:
    """A synthetic stand-in matching a Planetoid dataset's shape profile.

    Adds the standard Planetoid split masks (train/val/test) as extras:
    20 per class train, 500 val, 1000 test.
    """
    name = name.lower()
    if name not in PLANETOID_STATS:
        raise ValueError(f"Unknown planetoid dataset: {name}")
    n, e, f, c = PLANETOID_STATS[name]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, size=n).astype(np.int32)
    # Homophilous edges (like real citation graphs): 80% of edges connect
    # same-label nodes, so neighbor aggregation reinforces the signal.
    n_undirected = e // 2
    senders = rng.integers(0, n, size=n_undirected)
    receivers = np.empty(n_undirected, np.int64)
    same = rng.random(n_undirected) < 0.8
    by_label = [np.where(y == cls)[0] for cls in range(c)]
    receivers[~same] = rng.integers(0, n, size=int((~same).sum()))
    for cls in range(c):
        sel = same & (y[senders] == cls)
        receivers[sel] = rng.choice(by_label[cls], size=int(sel.sum()))
    edge_index = np.stack(
        [np.concatenate([senders, receivers]), np.concatenate([receivers, senders])]
    ).astype(np.int32)
    # Weak per-class feature signal on top of noise.
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[np.arange(n), y % f] += 2.0
    train_mask = np.zeros(n, bool)
    for cls in range(c):
        ids = np.where(y == cls)[0]
        train_mask[rng.choice(ids, size=min(20, len(ids)), replace=False)] = True
    rest = np.where(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    val_mask[rest[:500]] = True
    test_mask[rest[500:1500]] = True
    return GraphData(
        x=x,
        edge_index=edge_index,
        y=y,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
    )


def rmat_edges(
    scale: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    symmetric: bool = True,
    drop_self_loops: bool = True,
) -> np.ndarray:
    """R-MAT (Kronecker) edge generator, the Graph500 standard.

    Produces a ``[2, E]`` int32 edge index over ``2**scale`` nodes with a
    power-law degree distribution and hierarchical community structure, the
    two properties of real citation / social graphs that a uniform random
    graph lacks. Quadrant probabilities default to the canonical (0.57,
    0.19, 0.19, 0.05).
    """
    rng = np.random.default_rng(seed)
    e = num_edges // 2 if symmetric else num_edges
    s = np.zeros(e, np.int64)
    r = np.zeros(e, np.int64)
    for _ in range(scale):
        u = rng.random(e)
        right = u >= a + c  # sender high bit
        down = (u >= a) & (u < a + c) | (u >= a + b + c)
        s = 2 * s + right
        r = 2 * r + down
    if drop_self_loops:
        keep = s != r
        s, r = s[keep], r[keep]
    if symmetric:
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
    return np.stack([s, r]).astype(np.int32)


def community_graph(
    num_nodes: int,
    num_edges: int,
    *,
    community_size: int = 512,
    p_intra: float = 0.8,
    power: float = 0.8,
    seed: int = 0,
    scramble: bool = True,
    inter_locality: float = 0.0,
) -> np.ndarray:
    """Community-structured power-law graph (degree-corrected SBM).

    Models the structure real citation/co-purchase graphs have and
    uniform random graphs lack: nodes belong to ~``community_size``-node
    communities; ``p_intra`` of undirected edges stay inside the
    community (real citation graphs have modularity ~0.7); per-node
    degree propensities follow a Zipf-like law with exponent ``power``.
    ``scramble=True`` (default) applies a random node relabeling, so a
    consumer must *recover* the latent structure with a reordering pass
    (ops/reorder.py).

    ``inter_locality`` in [0, 1): community-pair affinity for the
    inter-community edges. 0 (default) wires them uniformly by global
    propensity — communities have no pairwise structure, the adversarial
    case for any community-aware partitioner. > 0 places communities on
    a latent ring and draws the target community at a geometric
    ring-distance with success probability ``inter_locality`` — the
    hierarchical "nearby fields cite each other" structure real citation
    graphs have, which a community-aware partitioner exploits.

    Returns a symmetric ``[2, E]`` int32 edge index (no self-loops).
    """
    rng = np.random.default_rng(seed)
    e = num_edges // 2
    n_comm = -(-num_nodes // community_size)
    comm = np.arange(num_nodes) // community_size
    # Zipf-ish degree propensity, shuffled within each community.
    prop = (1.0 + np.arange(num_nodes) % community_size) ** (-power)
    intra = rng.random(e) < p_intra
    # Sample sender by global propensity.
    p_global = prop / prop.sum()
    s = rng.choice(num_nodes, size=e, p=p_global)
    r = np.empty(e, np.int64)
    n_intra = int(intra.sum())
    # Intra edges: receiver from the sender's community (propensity-
    # weighted within the uniform community layout).
    base = comm[s[intra]] * community_size
    within = rng.choice(
        community_size,
        size=n_intra,
        p=prop[:community_size] / prop[:community_size].sum(),
    )
    r[intra] = np.minimum(base + within, num_nodes - 1)
    n_inter = e - n_intra
    if inter_locality > 0.0:
        # Ring-local target community: geometric distance, random side;
        # receiver drawn by the same within-community propensity.
        dist = rng.geometric(inter_locality, n_inter)
        side = rng.choice((-1, 1), n_inter)
        tgt = (comm[s[~intra]] + side * dist) % n_comm
        within_i = rng.choice(
            community_size,
            size=n_inter,
            p=prop[:community_size] / prop[:community_size].sum(),
        )
        r[~intra] = np.minimum(
            tgt * community_size + within_i, num_nodes - 1
        )
    else:
        r[~intra] = rng.choice(num_nodes, size=n_inter, p=p_global)
    keep = s != r
    s, r = s[keep], r[keep]
    if scramble:
        relabel = rng.permutation(num_nodes)
        s, r = relabel[s], relabel[r]
    return np.stack(
        [np.concatenate([s, r]), np.concatenate([r, s])]
    ).astype(np.int32)
