"""Dataset base class: download -> process -> cache (.npz) -> split.

Counterpart of the JAX package's ``data/datasets/base.py``: on first use a
dataset downloads its raw files, parses them into :class:`GraphData` graphs,
caches each graph's arrays in an ``.npz`` under ``<root>/<name>/processed``,
and thereafter loads straight from the cache. The cache format is the
reference's (``np.savez_compressed`` per graph, extras under ``extra_<key>``,
an ``np.savez`` meta file), so a cache written by either package is read by
the other. ``split()`` produces ratio-based shuffled train/val/test splits.

``download_url`` retries with backoff and, offline, fails with an error that
points at the synthetic generators.
"""

from __future__ import annotations

import os
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

import numpy as np

from ...utils.data_utils import GraphData

__all__ = ["Dataset", "download_url"]


def download_url(url: str, path: str, *, retries: int = 3, timeout: float = 30.0) -> str:
    """Download ``url`` to ``path`` with retry/backoff and a socket timeout.

    A file already at ``path`` is kept and nothing is fetched.
    """
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            tmp = path + ".part"
            with urllib.request.urlopen(url, timeout=timeout) as resp, open(
                tmp, "wb"
            ) as out:
                while chunk := resp.read(1 << 20):
                    out.write(chunk)
            os.replace(tmp, path)
            return path
        except (urllib.error.URLError, OSError, TimeoutError) as err:  # pragma: no cover
            last_err = err
            time.sleep(2**attempt)
    raise RuntimeError(
        f"Failed to download {url} after {retries} attempts ({last_err}). "
        "If this environment has no network access, use "
        "keras_geometric_tpu_torch.data.datasets.synthetic_planetoid() instead."
    )


class Dataset:
    """Base class for downloadable graph datasets."""

    def __init__(
        self,
        root: str = "data",
        name: str = "dataset",
        transform: Optional[Callable] = None,
        pre_transform: Optional[Callable] = None,
    ) -> None:
        self.root = root
        self.name = name
        self.transform = transform
        self.pre_transform = pre_transform
        self._data_list: list[GraphData] = []
        self.num_classes: int = 0
        self._process()

    # -- paths ---------------------------------------------------------------
    def _raw_dir(self) -> str:
        return os.path.join(self.root, self.name, "raw")

    def _processed_dir(self) -> str:
        return os.path.join(self.root, self.name, "processed")

    def _processed_path(self, idx: int) -> str:
        return os.path.join(self._processed_dir(), f"graph_{idx}.npz")

    def _meta_path(self) -> str:
        return os.path.join(self._processed_dir(), "meta.npz")

    # -- subclass hooks --------------------------------------------------------
    def _download(self) -> None:
        raise NotImplementedError

    def _load(self) -> tuple[list[GraphData], int]:
        """Parse raw files into graphs. Returns (graphs, num_classes)."""
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------------
    def _process(self) -> None:
        if os.path.exists(self._meta_path()):
            self._load_processed()
            return
        self._download()
        graphs, num_classes = self._load()
        if self.pre_transform is not None:
            graphs = [self.pre_transform(g) for g in graphs]
        self._data_list = graphs
        self.num_classes = num_classes
        self._save_processed()

    def _save_processed(self) -> None:
        os.makedirs(self._processed_dir(), exist_ok=True)
        for i, g in enumerate(self._data_list):
            arrays = {"x": g.x, "edge_index": g.edge_index}
            if g.edge_attr is not None:
                arrays["edge_attr"] = g.edge_attr
            if g.y is not None:
                arrays["y"] = g.y
            for k, v in g._additional_data.items():
                arrays[f"extra_{k}"] = v
            np.savez_compressed(self._processed_path(i), **arrays)
        np.savez(
            self._meta_path(),
            num_graphs=len(self._data_list),
            num_classes=self.num_classes,
        )

    def _load_processed(self) -> None:
        meta = np.load(self._meta_path())
        self.num_classes = int(meta["num_classes"])
        self._data_list = []
        for i in range(int(meta["num_graphs"])):
            with np.load(self._processed_path(i)) as data:
                extras = {
                    k[len("extra_"):]: data[k]
                    for k in data.files
                    if k.startswith("extra_")
                }
                self._data_list.append(
                    GraphData(
                        x=data["x"],
                        edge_index=data["edge_index"],
                        edge_attr=data["edge_attr"] if "edge_attr" in data else None,
                        y=data["y"] if "y" in data else None,
                        **extras,
                    )
                )

    # -- access ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._data_list)

    def __getitem__(self, idx: int) -> GraphData:
        g = self._data_list[idx]
        if self.transform is not None:
            g = self.transform(g)
        return g

    def split(
        self,
        train_ratio: float = 0.8,
        val_ratio: float = 0.1,
        *,
        shuffle: bool = True,
        seed: int = 0,
    ) -> tuple[list[GraphData], list[GraphData], list[GraphData]]:
        """Ratio-based train/val/test split over graphs."""
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        n_train = int(n * train_ratio)
        n_val = int(n * val_ratio)
        pick = lambda ids: [self[int(i)] for i in ids]
        return (
            pick(idx[:n_train]),
            pick(idx[n_train : n_train + n_val]),
            pick(idx[n_train + n_val :]),
        )
