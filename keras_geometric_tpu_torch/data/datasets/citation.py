"""Planetoid citation loaders: CiteSeer and PubMed.

Counterpart of the JAX package's ``data/datasets/citation.py``: downloads the
kimiyoung/planetoid pickles (``ind.<name>.{x,y,tx,ty,allx,ally,graph}`` plus
``test.index``), stitches ``allx`` + ``tx`` into the full feature matrix,
restores the shuffled test-row ordering via the test index, and converts the
adjacency dict into a deduplicated, sorted, symmetric edge list. Both ``x``
and ``y`` of the test block are reordered (the reference's fix of the
original loader, which reordered the labels only).

Stats: CiteSeer 3327 nodes / 9464 directed edges / 3703 features / 6
classes; PubMed 19717 nodes / 88676 directed edges / 500 features / 3
classes.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np

from ...utils.data_utils import GraphData
from .base import Dataset, download_url

__all__ = ["CitationDataset", "CiteSeerDataset", "PubMedDataset"]

_URL_TEMPLATE = "https://github.com/kimiyoung/planetoid/raw/master/data/ind.{name}.{file}"
_FILES = ("x", "y", "tx", "ty", "allx", "ally", "graph", "test.index")


class CitationDataset(Dataset):
    """Planetoid-format citation network loader."""

    available = ("citeseer", "pubmed")

    def __init__(
        self,
        root: str,
        name: str,
        transform: Optional[Callable] = None,
        pre_transform: Optional[Callable] = None,
    ) -> None:
        if name.lower() not in self.available:
            raise ValueError(
                f"Dataset {name} not available. Choose from {list(self.available)}"
            )
        super().__init__(root, name.lower(), transform, pre_transform)

    def _raw_path(self, file: str) -> str:
        suffix = "" if file == "test.index" else ".pkl"
        return os.path.join(self._raw_dir(), f"ind.{self.name}.{file}{suffix}")

    def _download(self) -> None:
        for file in _FILES:
            url = _URL_TEMPLATE.format(name=self.name, file=file)
            download_url(url, self._raw_path(file))

    def _unpickle(self, file: str):
        with open(self._raw_path(file), "rb") as f:
            return pickle.load(f, encoding="latin1")

    def _load(self) -> tuple[list[GraphData], int]:
        tx, ty = self._unpickle("tx"), self._unpickle("ty")
        allx, ally = self._unpickle("allx"), self._unpickle("ally")
        graph_dict = self._unpickle("graph")
        with open(self._raw_path("test.index")) as f:
            test_idx = np.array([int(i) for i in f.read().split()], dtype=np.int64)

        x = np.vstack((allx.toarray(), tx.toarray())).astype(np.float32)
        y = np.vstack((ally, ty)).astype(np.int64)

        # The tail rows of x / y are the test block in shuffled order: the
        # i-th tail row belongs to node test_idx[i]. Reorder both.
        n_all = allx.shape[0]
        x_fixed, y_fixed = x.copy(), y.copy()
        x_fixed[test_idx] = x[n_all + np.arange(len(test_idx))]
        y_fixed[test_idx] = y[n_all + np.arange(len(test_idx))]
        x, y = x_fixed, y_fixed

        edge_index = self._graph_dict_to_edge_index(graph_dict)
        graph = GraphData(x=x, edge_index=edge_index, y=np.argmax(y, axis=1))
        return [graph], int(y.shape[1])

    @staticmethod
    def _graph_dict_to_edge_index(graph_dict: dict) -> np.ndarray:
        edges = set()
        for src, tgts in graph_dict.items():
            for tgt in tgts:
                edges.add((int(src), int(tgt)))
                edges.add((int(tgt), int(src)))
        return np.array(sorted(edges), dtype=np.int64).T


class CiteSeerDataset(CitationDataset):
    """CiteSeer: 3327 nodes, 6 classes."""

    def __init__(self, root: str = "data", **kwargs) -> None:
        super().__init__(root, "citeseer", **kwargs)


class PubMedDataset(CitationDataset):
    """PubMed: 19717 nodes, 3 classes."""

    def __init__(self, root: str = "data", **kwargs) -> None:
        super().__init__(root, "pubmed", **kwargs)
