"""Cora citation network loader (LINQS distribution).

Counterpart of the JAX package's ``data/datasets/cora.py``: downloads
``cora.tgz``, parses ``cora.content`` (node id, bag-of-words features,
string label) and ``cora.cites`` (citing pairs), builds a symmetric edge
list (both directions appended per citation), and encodes string labels as
sorted-unique integer indices.

Stats: 2708 nodes, 5429 citations (10858 directed edges), 1433 features,
7 classes.
"""

from __future__ import annotations

import os
import tarfile
from typing import Callable, Optional

import numpy as np

from ...utils.data_utils import GraphData
from .base import Dataset, download_url

__all__ = ["CoraDataset"]


class CoraDataset(Dataset):
    """The Cora citation network (single-graph node classification)."""

    url = "https://linqs-data.soe.ucsc.edu/public/lbc/cora.tgz"

    def __init__(
        self,
        root: str = "data",
        transform: Optional[Callable] = None,
        pre_transform: Optional[Callable] = None,
    ) -> None:
        super().__init__(root, "cora", transform, pre_transform)

    def _download(self) -> None:
        tgz_path = os.path.join(self._raw_dir(), "cora.tgz")
        download_url(self.url, tgz_path)
        extracted = os.path.join(self._raw_dir(), "cora")
        if not os.path.exists(extracted):
            with tarfile.open(tgz_path, "r:gz") as tar:
                tar.extractall(self._raw_dir(), filter="data")

    def _load(self) -> tuple[list[GraphData], int]:
        raw = os.path.join(self._raw_dir(), "cora")
        content = np.genfromtxt(
            os.path.join(raw, "cora.content"), dtype=np.dtype(str)
        )
        features = content[:, 1:-1].astype(np.float32)
        labels = self._encode_labels(content[:, -1])
        id_map = {node_id: i for i, node_id in enumerate(content[:, 0])}

        cites = np.genfromtxt(os.path.join(raw, "cora.cites"), dtype=np.dtype(str))
        edges: list[tuple[int, int]] = []
        for a, b in cites:
            ia, ib = id_map.get(a), id_map.get(b)
            if ia is not None and ib is not None:
                edges.append((ia, ib))
                edges.append((ib, ia))
        edge_index = np.array(edges, dtype=np.int64).T

        graph = GraphData(x=features, edge_index=edge_index, y=labels)
        return [graph], int(len(np.unique(labels)))

    @staticmethod
    def _encode_labels(labels: np.ndarray) -> np.ndarray:
        uniq = {label: i for i, label in enumerate(np.unique(labels))}
        return np.array([uniq[label] for label in labels], dtype=np.int64)
