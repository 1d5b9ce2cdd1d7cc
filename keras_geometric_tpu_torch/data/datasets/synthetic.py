"""Synthetic graph generators.

Counterpart of the JAX package's ``data/datasets/synthetic.py``. Ported so
far: :func:`community_graph`, which draws the same random numbers in the same
order as the reference's, so a seed gives the same edges, bit for bit. The
generators that return a ``GraphData`` (``synthetic_graph``,
``synthetic_planetoid``) and ``rmat_edges`` come with the data tier.
"""

from __future__ import annotations

import numpy as np

__all__ = ["community_graph"]


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
