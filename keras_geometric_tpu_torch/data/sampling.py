"""Neighbor-sampling pipeline for SAGE-style minibatch training.

Counterpart of the JAX package's ``data/sampling.py``, host-side numpy:

- ``NeighborSampler``: per-layer uniform fanout sampling (GraphSAGE,
  Hamilton et al. 2017) from the in-edges of each node, producing
  fixed-shape subgraph buckets: every batch has identical array shapes;
- sampled subgraphs use local node ids, first-seen order, with a
  ``node_map`` back to global ids; layer ``k``'s edges connect layer-``k+1``
  frontier nodes (senders) to layer-``k`` nodes (receivers), the real edges
  receiver-sorted and followed by masked padding slots;
- padding: missing neighbors (degree < fanout) are masked edges; the node
  bucket holds ``B * (1 + f0 + f0 * f1 + ...)`` slots, the worst case.

The random stream is the reference's: one generator per sampler, which
shuffles an epoch's nodes first and then draws per layer either one seed
for the native sampler (``native.available()``; ``std::mt19937_64`` in
``native/libgraph_core.so``) or one ``choice`` per node above the fanout.
One seed on one machine gives bit-equal buckets in both packages.

``prefetch`` runs an iterator in a background thread so host sampling
overlaps device steps. The thread does host work only; copies to the card
and launches belong to the consuming thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np

from .. import native

__all__ = ["SampledSubgraph", "NeighborSampler", "prefetch"]


class SampledSubgraph(NamedTuple):
    """Fixed-shape k-hop sampled subgraph in local ids.

    ``layers[k] = (senders_local, receivers_local, edge_mask)`` are the
    edges used by conv layer ``k`` (k=0 is the layer nearest the output).
    ``node_map`` maps local id -> global id (padded slots = -1);
    ``node_mask`` marks real nodes; ``seed_mask`` marks the first
    ``batch_size`` slots that are the seed (output) nodes.
    """

    node_map: np.ndarray  # [N_bucket] int64
    node_mask: np.ndarray  # [N_bucket] bool
    seed_ids: np.ndarray  # [B] int64 global seed ids
    seed_mask: np.ndarray  # [B] bool (False for padded seeds)
    layers: tuple  # k entries of (senders, receivers, edge_mask)


class NeighborSampler:
    """Uniform per-layer fanout sampler over in-neighbors.

    Args:
        edge_index: ``[2, E]`` global COO (senders, receivers).
        num_nodes: global node count.
        fanouts: neighbors sampled per layer, output-side first
            (e.g. ``(25, 10)`` = 25 for layer 0, 10 for layer 1).
        seed: PRNG seed.
    """

    def __init__(
        self,
        edge_index: np.ndarray,
        num_nodes: int,
        fanouts: tuple[int, ...],
        *,
        seed: int = 0,
    ) -> None:
        edge_index = np.asarray(edge_index)
        if edge_index.shape[0] != 2:
            edge_index = edge_index.T
        senders = edge_index[0].astype(np.int64)
        receivers = edge_index[1].astype(np.int64)
        # CSC build: in-edges grouped by receiver.
        order = np.argsort(receivers, kind="stable")
        self._sorted_senders = senders[order]
        counts = np.bincount(receivers, minlength=num_nodes)
        self._in_ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(counts, out=self._in_ptr[1:])
        self.num_nodes = num_nodes
        self.fanouts = tuple(int(f) for f in fanouts)
        self._rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int):
        """For each node, sample up to ``fanout`` in-neighbors (without
        replacement when degree >= fanout). Returns [len(nodes), fanout]
        sender ids with -1 padding. Uses the native sampler when the library
        loads (the Python loop dominates epoch time at OGB scale)."""
        if native.available():
            seed = int(self._rng.integers(0, 2**63 - 1))
            return native.uniform_sample(
                self._sorted_senders,
                self._in_ptr,
                np.ascontiguousarray(nodes, np.int64),
                fanout,
                seed=seed,
            )
        out = np.full((len(nodes), fanout), -1, np.int64)
        for i, v in enumerate(nodes):
            lo, hi = self._in_ptr[v], self._in_ptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= fanout:
                out[i, :deg] = self._sorted_senders[lo:hi]
            else:
                pick = self._rng.choice(deg, size=fanout, replace=False)
                out[i] = self._sorted_senders[lo + pick]
        return out

    def sample(self, seeds: np.ndarray, *, batch_size: int | None = None):
        """Sample the k-hop neighborhood of ``seeds`` into a fixed-shape
        bucket. ``batch_size`` pads the seed set (defaults to len(seeds))."""
        seeds = np.asarray(seeds, np.int64)
        b = batch_size or len(seeds)
        if len(seeds) > b:
            raise ValueError(f"{len(seeds)} seeds > batch_size {b}")

        # Bucket capacity: worst-case frontier growth.
        caps = [b]
        for f in self.fanouts:
            caps.append(caps[-1] * f)
        n_bucket = sum(caps)

        node_map = np.full(n_bucket, -1, np.int64)
        node_map[: len(seeds)] = seeds
        local_of: dict[int, int] = {int(g): i for i, g in enumerate(seeds)}
        n_used = len(seeds)

        frontier = seeds
        frontier_local = np.arange(len(seeds), dtype=np.int64)
        layers = []
        for k, fanout in enumerate(self.fanouts):
            e_cap = caps[k] * fanout
            s_loc = np.zeros(e_cap, np.int32)
            r_loc = np.zeros(e_cap, np.int32)
            mask = np.zeros(e_cap, bool)
            nbrs = self._sample_neighbors(frontier, fanout)  # [|F|, fanout]
            next_frontier: list[int] = []
            next_frontier_local: list[int] = []
            e = 0
            for i in range(len(frontier)):
                for g in nbrs[i]:
                    if g < 0:
                        continue
                    g = int(g)
                    loc = local_of.get(g)
                    if loc is None:
                        loc = n_used
                        local_of[g] = loc
                        node_map[loc] = g
                        n_used += 1
                        next_frontier.append(g)
                        next_frontier_local.append(loc)
                    s_loc[e] = loc
                    r_loc[e] = frontier_local[i]
                    mask[e] = True
                    e += 1
            # Receiver-sort the real edges; the masked padding slots
            # (senders = receivers = 0) trail them.
            order = np.argsort(r_loc[:e], kind="stable")
            s_loc[:e] = s_loc[:e][order]
            r_loc[:e] = r_loc[:e][order]
            layers.append((s_loc, r_loc, mask))
            frontier = np.array(next_frontier, np.int64)
            frontier_local = np.array(next_frontier_local, np.int64)
            if len(frontier) == 0:
                frontier = np.zeros(0, np.int64)
                frontier_local = np.zeros(0, np.int64)

        seed_ids = np.zeros(b, np.int64)
        seed_ids[: len(seeds)] = seeds
        seed_mask = np.arange(b) < len(seeds)
        return SampledSubgraph(
            node_map=node_map,
            node_mask=node_map >= 0,
            seed_ids=seed_ids,
            seed_mask=seed_mask,
            layers=tuple(layers),
        )

    def epoch(
        self, nodes: np.ndarray, batch_size: int, *, shuffle: bool = True
    ) -> Iterator[SampledSubgraph]:
        """Iterate fixed-shape minibatches covering ``nodes`` once."""
        nodes = np.asarray(nodes, np.int64)
        if shuffle:
            nodes = nodes.copy()
            self._rng.shuffle(nodes)
        for i in range(0, len(nodes), batch_size):
            yield self.sample(nodes[i : i + batch_size], batch_size=batch_size)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so host
    sampling overlaps device execution. Items come out in order, each once;
    an exception the iterator raises is raised again here, after the items
    it yielded before it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    failed: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as err:  # handed to the consuming thread
            failed.append(err)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    if failed:
        raise failed[0]
