"""Host-side graph partitioning for multi-device execution.

Counterpart of the JAX package's ``parallel/partition.py``, host numpy with
the same arrays, bit for bit: the node set is split into ``num_parts`` equal
contiguous ranges (the "sequence-parallel" axis of a GNN), and every edge is
assigned to the partition that owns its **receiver**. Consequences:

- all segment reductions (sum/mean/max, GATv2 edge softmax) are purely
  local to a device: no cross-device combining pass is ever needed;
- only *sender features* are remote; each rank gathers them from an
  all-gathered (or halo-exchanged) feature table;
- per-partition arrays are padded to identical shapes (one program serves
  every rank, and each rank keeps its slice).

``partition_graph`` also precomputes GCN normalization weights globally
(degree is a global property), so the distributed forward needs no extra
communication for them.

``edge_multiple=128`` (the per-part edge padding) is the reference's default
and is kept so that the arrays are the reference's: it is a TPU lane constant
and means nothing to the card, whose kernels take any edge count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.graph_ops import round_up

__all__ = [
    "PartitionedGraph",
    "partition_graph",
    "community_partition_order",
]


class PartitionedGraph(NamedTuple):
    """Per-partition padded arrays; leading axis = partition id.

    Shapes: ``P`` parts, ``L = nodes_per_part``, ``E = edges_per_part``.
    """

    senders_global: np.ndarray  # [P, E] int32, global sender node ids
    receivers_local: np.ndarray  # [P, E] int32, receiver ids local to part
    edge_mask: np.ndarray  # [P, E] bool
    edge_weight: np.ndarray | None  # [P, E] float32 (e.g. GCN norm) or None
    edge_perm: np.ndarray  # [P, E] int32 original edge id (pad = num_edges)
    node_mask: np.ndarray  # [P, L] bool — True for real (unpadded) nodes
    num_nodes: int  # true global node count
    num_edges: int  # true global edge count
    nodes_per_part: int  # L (padded, equal across parts)
    num_parts: int

    @property
    def padded_num_nodes(self) -> int:
        return self.num_parts * self.nodes_per_part


def _halo_cost(
    s: np.ndarray, r: np.ndarray, inv: np.ndarray, num_parts: int, l: int
) -> int:
    """Exact cost of an order under the halo plan's padding rule: the
    all_to_all moves ``P * h`` rows per device where ``h`` is the MAX over
    (receiver-part, owner-part) pairs of distinct remote senders
    (:func:`~.halo.build_halo_plan`)."""
    s2, r2 = inv[s], inv[r]
    cs, cr = s2 // l, r2 // l
    inter = cs != cr
    key = (cr[inter] * num_parts + cs[inter]) * (
        num_parts * l
    ) + s2[inter]
    pairs = np.unique(key) // (num_parts * l)
    if pairs.size == 0:
        return 0
    return int(np.bincount(pairs).max()) * num_parts


def community_partition_order(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    labels: np.ndarray | None = None,
    iters: int = 25,
    tol: float = 0.002,
) -> np.ndarray:
    """Balance-constrained community-to-device node order (min-cut).

    Receiver-range partitioning after a plain cluster reorder splits the
    node sequence blindly at ``L`` boundaries. This consumes the LPA
    community labels directly and builds candidate orders, returning
    whichever one an exact host-side halo count (:func:`_halo_cost`) says
    moves fewer rows:

    - **affinity bin-pack**: communities largest-first, each to the part
      with the highest inter-community edge affinity among parts with node
      capacity left; wins when communities have pairwise affinity structure;
    - **balanced chain split**: communities along the greedy connectivity
      chain (``ops.reorder`` semantics), cut into P contiguous node-balanced
      groups; wins at high P, where the chain's adjacency matters more than
      global affinity;
    - the plain chain order with blind ``L``-boundary cuts, so the selector
      never returns anything worse than a cluster reorder.

    When inter-community edges have no community-pair structure, the
    distinct-remote-sender floor holds for every assignment and no order
    beats the plain one by much.
    """
    from scipy.sparse import csr_matrix

    from ..ops import reorder

    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    if labels is None:
        labels = reorder.lpa_labels(s, r, num_nodes, iters=iters, tol=tol)
    _, cl = np.unique(labels, return_inverse=True)
    n_c = int(cl.max()) + 1
    sizes = np.bincount(cl, minlength=n_c).astype(np.int64)
    cs, cr = cl[s], cl[r]
    inter = cs != cr
    w = csr_matrix(
        (
            np.ones(int(inter.sum()), np.int64),
            (cs[inter], cr[inter]),
        ),
        shape=(n_c, n_c),
    )
    w = (w + w.T).tocsr()

    cap_l = round_up(max(num_nodes, 1), num_parts) // num_parts

    # Candidate 1: affinity-greedy bin-pack.
    cap = np.full(num_parts, cap_l, np.int64)
    assign = np.full(n_c, -1, np.int64)
    rank = np.zeros(n_c, np.int64)  # placement order within the chip
    placed = np.zeros(num_parts, np.int64)
    # affinity[p, c]: inter-edge count between community c and chip p's
    # already-assigned communities.
    affinity = np.zeros((num_parts, n_c), np.int64)
    for c in np.argsort(-sizes, kind="stable"):
        fits = cap >= sizes[c]
        cand = np.flatnonzero(fits) if fits.any() else np.arange(num_parts)
        scores = affinity[cand, c]
        tied = cand[scores == scores.max()]
        best = int(tied[np.argmax(cap[tied])])
        assign[c] = best
        rank[c] = placed[best]
        placed[best] += 1
        cap[best] -= sizes[c]
        lo, hi = w.indptr[c], w.indptr[c + 1]
        affinity[best, w.indices[lo:hi]] += w.data[lo:hi]
    order_pack = np.lexsort(
        (np.arange(num_nodes), rank[cl], assign[cl])
    ).astype(np.int64)

    # Candidate 2: balanced split of the connectivity chain — like
    # cluster_order + contiguous ranges, but cuts aligned to community
    # boundaries: each community goes to the chip its chain-order
    # midpoint falls in at perfectly balanced fractions of N.
    chain = reorder._cluster_chain_rank(cs, cr, n_c, sizes)
    by_chain = np.argsort(chain, kind="stable")
    cum = np.cumsum(sizes[by_chain])
    mid = cum - sizes[by_chain] / 2.0
    chip_seq = np.minimum(
        (mid / (num_nodes / num_parts)).astype(np.int64), num_parts - 1
    )
    chip_chain = np.zeros(n_c, np.int64)
    chip_chain[by_chain] = chip_seq
    order_chain = np.lexsort(
        (np.arange(num_nodes), chain[cl], chip_chain[cl])
    ).astype(np.int64)

    # Candidate 3: the plain chain order with blind L-boundary cuts —
    # exactly what cluster_order + partition_graph does, so the selector
    # never returns anything worse than that.
    order_plain = np.lexsort(
        (np.arange(num_nodes), chain[cl])
    ).astype(np.int64)

    best_order = min(
        (order_pack, order_chain, order_plain),
        key=lambda o: _halo_cost(
            s, r, reorder.invert_order(o), num_parts, cap_l
        ),
    )
    return best_order


def partition_graph(
    edge_index: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    edge_weight: np.ndarray | None = None,
    gcn_normalize: bool = False,
    add_self_loops: bool = False,
    edge_multiple: int = 128,
) -> PartitionedGraph:
    """Partition a COO graph by receiver range into ``num_parts`` shards.

    Args:
        edge_index: ``[2, E]`` (or ``[E, 2]``) global COO edges.
        num_nodes: global node count.
        num_parts: number of devices/shards.
        edge_weight: optional per-edge weights carried through the permute.
        gcn_normalize: precompute symmetric GCN weights globally
            (matching ops.graph_ops.gcn_norm semantics) and fold them into
            ``edge_weight``.
        add_self_loops: append one self-loop per real node before
            partitioning (GCN-style preprocessing).
        edge_multiple: pad per-part edge counts to this multiple.
    """
    edge_index = np.asarray(edge_index)
    if edge_index.shape[0] != 2:
        edge_index = edge_index.T
    # int32 throughout: node ids fit, and int64 passes over 100M+-edge
    # arrays cost host time.
    senders = np.ascontiguousarray(edge_index[0], np.int32)
    receivers = np.ascontiguousarray(edge_index[1], np.int32)

    if add_self_loops:
        loops = np.arange(num_nodes, dtype=np.int32)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
        if edge_weight is not None:
            edge_weight = np.concatenate(
                [np.asarray(edge_weight), np.ones(num_nodes, np.float32)]
            )

    num_edges = senders.shape[0]

    if gcn_normalize:
        from .. import native

        # Native C++ routine (the semantics of ops.graph_ops.gcn_norm:
        # receiver in-degree, (d+1e-12)^-1/2, inf -> 0).
        norm = np.asarray(
            native.gcn_norm_weights(senders, receivers, num_nodes),
            np.float32,
        )
        edge_weight = norm if edge_weight is None else edge_weight * norm

    nodes_per_part = round_up(max(num_nodes, 1), num_parts) // num_parts

    # ONE global stable receiver sort (native counting sort when built):
    # contiguous receiver ranges mean globally-sorted == grouped by part
    # AND receiver-sorted within each part (no O(P·E log E) per-part sort).
    from .. import native

    perm = native.coo_to_csr_perm(receivers, num_nodes)[0].astype(np.int32)
    s_sorted = senders[perm]
    r_sorted = receivers[perm]
    ids_sorted = perm  # arange(E)[perm] == perm
    w_sorted = (
        np.asarray(edge_weight, np.float32)[perm]
        if edge_weight is not None
        else None
    )
    bounds = np.searchsorted(
        r_sorted, np.arange(num_parts + 1, dtype=np.int64) * nodes_per_part
    )
    counts = np.diff(bounds)
    edges_per_part = round_up(max(int(counts.max()), 1), edge_multiple)

    s_out = np.zeros((num_parts, edges_per_part), np.int32)
    r_out = np.zeros((num_parts, edges_per_part), np.int32)
    m_out = np.zeros((num_parts, edges_per_part), bool)
    p_out = np.full((num_parts, edges_per_part), num_edges, np.int32)
    w_out = (
        np.zeros((num_parts, edges_per_part), np.float32)
        if edge_weight is not None
        else None
    )

    for p in range(num_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        k = hi - lo
        s_out[p, :k] = s_sorted[lo:hi]
        r_out[p, :k] = r_sorted[lo:hi] - p * nodes_per_part
        m_out[p, :k] = True
        p_out[p, :k] = ids_sorted[lo:hi]
        if w_out is not None:
            w_out[p, :k] = w_sorted[lo:hi]
        # Padded edges point at local node 0 with mask False.

    node_ids = np.arange(num_parts * nodes_per_part).reshape(
        num_parts, nodes_per_part
    )
    node_mask = node_ids < num_nodes

    return PartitionedGraph(
        senders_global=s_out,
        receivers_local=r_out,
        edge_mask=m_out,
        edge_weight=w_out,
        edge_perm=p_out,
        node_mask=node_mask,
        num_nodes=num_nodes,
        num_edges=num_edges,
        nodes_per_part=nodes_per_part,
        num_parts=num_parts,
    )
