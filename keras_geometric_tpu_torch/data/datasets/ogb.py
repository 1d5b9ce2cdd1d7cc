"""OGB-scale node-property datasets with memory-mapped CSR shards.

Counterpart of the JAX package's ``data/datasets/ogb.py``, with its storage
layout, so either package reads a cache the other wrote:

- one-time ``prepare``: parse the official OGB zip / extracted raw CSVs
  (``raw/{edge,node-feat,node-label}.csv.gz`` + ``split/*/{train,valid,
  test}.csv.gz``, the layout inside the URLs below) or, with
  ``synthetic=True``, a size-faithful stand-in, into a receiver-sorted CSR
  cache on disk (``.npy`` files opened with ``mmap_mode='r'``: nothing is
  resident until sliced). Official edges are directed; the standard GCN
  preprocessing symmetrizes and coalesces them, so both directions are
  stored once each and the diagonal is dropped;
- ``load_partition(part, num_parts)``: read only the edge rows of one
  receiver range, without materializing the full graph.

A directory that already holds a ``meta.json`` is read as it is and never
written. The arrays come back as read-only memory maps: copy a slice
(``np.ascontiguousarray``) before handing it to ``torch``.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

__all__ = ["OGBNodeDataset", "OGB_STATS", "CSRShard"]

# name -> (num_nodes, num_directed_edges(after sym), num_feats, num_classes)
OGB_STATS = {
    "ogbn-arxiv": (169_343, 2_332_486, 128, 40),
    "ogbn-products": (2_449_029, 123_718_280, 100, 47),
}

_URLS = {
    "ogbn-arxiv": "https://snap.stanford.edu/ogb/data/nodeproppred/arxiv.zip",
    "ogbn-products": "https://snap.stanford.edu/ogb/data/nodeproppred/products.zip",
}


class CSRShard(NamedTuple):
    senders: np.ndarray  # [E_part] int32, global ids (mmap slice)
    receivers: np.ndarray  # [E_part] int32, receiver-sorted
    row_range: tuple[int, int]  # [lo, hi) receiver node range
    edge_offset: int  # global edge index of first edge


class OGBNodeDataset:
    """Receiver-sorted CSR on disk; features/labels memory-mapped."""

    def __init__(
        self,
        name: str,
        root: str = "data",
        *,
        synthetic: bool = False,
        seed: int = 0,
    ) -> None:
        if name not in OGB_STATS:
            raise ValueError(
                f"Unknown OGB dataset {name}; available: {list(OGB_STATS)}"
            )
        self.name = name
        self.root = os.path.join(root, name.replace("-", "_"))
        self.num_nodes, self.num_edges, self.num_feats, self.num_classes = (
            OGB_STATS[name]
        )
        if not self._prepared():
            self._prepare(synthetic=synthetic, seed=seed)
        self._load_meta()

    # -- storage -------------------------------------------------------------
    def _path(self, fname: str) -> str:
        return os.path.join(self.root, fname)

    def _prepared(self) -> bool:
        return os.path.exists(self._path("meta.json"))

    def _prepare(self, *, synthetic: bool, seed: int) -> None:
        os.makedirs(self.root, exist_ok=True)
        n, e, f, c = OGB_STATS[self.name]
        if synthetic:
            rng = np.random.default_rng(seed)
            half = e // 2
            s = rng.integers(0, n, half, dtype=np.int64)
            r = rng.integers(0, n, half, dtype=np.int64)
            senders = np.concatenate([s, r])
            receivers = np.concatenate([r, s])
            x = rng.standard_normal((n, f)).astype(np.float32)
            y = rng.integers(0, c, n).astype(np.int32)
            x[np.arange(n), y % f] += 1.5
            # Standard OGB-style split: 60/20/20 at random.
            rng2 = np.random.default_rng(42)
            perm = rng2.permutation(n)
            split = {
                "train": perm[: int(0.6 * n)],
                "valid": perm[int(0.6 * n): int(0.8 * n)],
                "test": perm[int(0.8 * n):],
            }
        else:
            raw_dir = self._find_raw()
            if raw_dir is None:
                raise RuntimeError(
                    f"Raw OGB data for {self.name} not found and "
                    f"synthetic=False. Download {_URLS[self.name]} and "
                    f"place the zip (or its extracted contents) under "
                    f"{self.root}, or pass synthetic=True for a "
                    "size-faithful stand-in."
                )
            senders, receivers, x, y, split = self._parse_official(raw_dir)
            n = x.shape[0]
        order = np.argsort(receivers, kind="stable")
        np.save(self._path("senders.npy"), senders[order].astype(np.int32))
        np.save(self._path("receivers.npy"), receivers[order].astype(np.int32))
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(receivers, minlength=n), out=row_ptr[1:])
        np.save(self._path("row_ptr.npy"), row_ptr)
        np.save(self._path("x.npy"), np.asarray(x, np.float32))
        np.save(self._path("y.npy"), np.asarray(y, np.int32))
        np.savez(self._path("split.npz"), **split)
        with open(self._path("meta.json"), "w") as fh:
            json.dump(
                {
                    "num_nodes": int(n),
                    "num_edges": len(senders),
                    "num_feats": int(x.shape[1]),
                    "num_classes": int(np.asarray(y).max()) + 1,
                    "synthetic": synthetic,
                },
                fh,
            )

    # -- official-zip ingestion ----------------------------------------------
    def _find_raw(self) -> str | None:
        """Locate the official raw CSV directory, extracting a zip if one
        is present. Accepted layouts (``short`` = e.g. ``arxiv``):

        - ``{root}/raw/`` (already extracted, flattened)
        - ``{root}/{short}/raw/`` (zip extracted in place)
        - ``{root}/{short}.zip`` or ``{root}/../{short}.zip`` (the
          official download, extracted on first use)
        """
        import zipfile

        short = self.name.split("-", 1)[1]
        candidates = [self._path("raw"), os.path.join(self.root, short, "raw")]
        for cand in candidates:
            if os.path.isdir(cand):
                return os.path.dirname(cand) or self.root
        for zpath in (
            self._path(f"{short}.zip"),
            os.path.join(os.path.dirname(self.root) or ".", f"{short}.zip"),
        ):
            if os.path.exists(zpath):
                with zipfile.ZipFile(zpath) as zf:
                    zf.extractall(self.root)
                for cand in candidates:
                    if os.path.isdir(cand):
                        return os.path.dirname(cand) or self.root
        return None

    @staticmethod
    def _read_csv_gz(path: str, dtype) -> np.ndarray:
        """Header-less CSV (optionally gzipped) -> 2-D array: pandas' C
        reader when it is installed (products' edge file is 123M rows),
        ``np.loadtxt`` otherwise."""
        try:
            import pandas as pd

            return pd.read_csv(
                path, header=None, dtype=dtype
            ).to_numpy()
        except ImportError:
            return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)

    def _parse_official(self, base: str):
        """Parse the official OGB node-prop layout rooted at ``base``:
        ``raw/node-feat.csv.gz`` [N, F] floats, ``raw/node-label.csv.gz``
        [N, 1] ints, ``raw/edge.csv.gz`` [E, 2] directed src,dst pairs
        (symmetrized here, the standard GCN preprocessing), and
        ``split/<scheme>/{train,valid,test}.csv.gz`` node-index lists
        (scheme is ``time`` for arxiv, ``sales_ranking`` for products,
        discovered, not hardcoded)."""
        raw = os.path.join(base, "raw")

        def pick(stem: str) -> str:
            for suffix in (".csv.gz", ".csv"):
                p = os.path.join(raw, stem + suffix)
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(
                f"{stem}.csv(.gz) missing under {raw}"
            )

        edges = self._read_csv_gz(pick("edge"), np.int64)
        x = self._read_csv_gz(pick("node-feat"), np.float32)
        y = self._read_csv_gz(pick("node-label"), np.int64).ravel()
        src, dst = edges[:, 0], edges[:, 1]
        senders = np.concatenate([src, dst])
        receivers = np.concatenate([dst, src])
        # The standard preprocessing (`to_undirected`) coalesces: reciprocal
        # raw pairs must not get weight 2 and raw self-loops must not
        # survive. Dedup on packed (s, r) keys and drop the diagonal before
        # any CSR cache is built.
        n_guess = int(max(senders.max(), receivers.max())) + 1
        keys = senders * np.int64(n_guess) + receivers
        keep = np.unique(keys, return_index=True)[1]
        senders, receivers = senders[keep], receivers[keep]
        off_diag = senders != receivers
        senders, receivers = senders[off_diag], receivers[off_diag]

        split_root = os.path.join(base, "split")
        split: dict[str, np.ndarray] = {}
        if os.path.isdir(split_root):
            for scheme in sorted(os.listdir(split_root)):
                sdir = os.path.join(split_root, scheme)
                try:
                    split = {
                        part: self._read_csv_gz(
                            os.path.join(sdir, part + ".csv.gz"), np.int64
                        ).ravel()
                        for part in ("train", "valid", "test")
                    }
                    break
                except (FileNotFoundError, OSError):
                    continue
        if not split:
            raise FileNotFoundError(
                f"no split/<scheme>/{{train,valid,test}}.csv.gz under {base}"
            )
        return senders, receivers, x, y, split

    def _load_meta(self) -> None:
        with open(self._path("meta.json")) as fh:
            meta = json.load(fh)
        self.num_edges = int(meta["num_edges"])
        # Parsed real data overrides the published stats (and lets the
        # fixture-zip tests exercise the full ingestion on tiny graphs).
        self.num_nodes = int(meta.get("num_nodes", self.num_nodes))
        self.num_feats = int(meta.get("num_feats", self.num_feats))
        self.num_classes = int(meta.get("num_classes", self.num_classes))
        self.is_synthetic = bool(meta.get("synthetic", False))
        self.row_ptr = np.load(self._path("row_ptr.npy"), mmap_mode="r")

    # -- access ---------------------------------------------------------------
    @property
    def x(self) -> np.ndarray:
        return np.load(self._path("x.npy"), mmap_mode="r")

    @property
    def y(self) -> np.ndarray:
        return np.load(self._path("y.npy"), mmap_mode="r")

    def split_idx(self) -> dict[str, np.ndarray]:
        with np.load(self._path("split.npz")) as z:
            return {k: z[k] for k in z.files}

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Full (mmap) receiver-sorted edge arrays."""
        return (
            np.load(self._path("senders.npy"), mmap_mode="r"),
            np.load(self._path("receivers.npy"), mmap_mode="r"),
        )

    def load_partition(self, part: int, num_parts: int) -> CSRShard:
        """Edges whose receiver falls in partition ``part``'s node range;
        reads only that byte range from disk."""
        nodes_per_part = -(-self.num_nodes // num_parts)
        lo = part * nodes_per_part
        hi = min((part + 1) * nodes_per_part, self.num_nodes)
        e_lo, e_hi = int(self.row_ptr[lo]), int(self.row_ptr[hi])
        senders, receivers = self.edges()
        return CSRShard(
            senders=np.asarray(senders[e_lo:e_hi]),
            receivers=np.asarray(receivers[e_lo:e_hi]),
            row_range=(lo, hi),
            edge_offset=e_lo,
        )
