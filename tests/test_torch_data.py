"""The port's data tier against the JAX package's: padding helpers, ``Graph``,
``GraphData`` and batching, the synthetic generators, the dataset caches and
loaders (tiny raw files written here, the OGB fixture zip, the tracked
ogbn-arxiv cache). Everything here is host numpy; nothing is downloaded.
"""

import gzip
import io
import pathlib
import pickle
import shutil
import tarfile
import urllib.request

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from keras_geometric_tpu import graph as jgraph
from keras_geometric_tpu.data import datasets as jds
from keras_geometric_tpu.data.datasets import base as jbase
from keras_geometric_tpu.data.datasets import synthetic as jsyn
from keras_geometric_tpu.ops import graph_ops as jgo
from keras_geometric_tpu.utils import data_utils as jdu
from keras_geometric_tpu_torch import graph as tgraph
from keras_geometric_tpu_torch.data import datasets as tds
from keras_geometric_tpu_torch.data.datasets import base as tbase
from keras_geometric_tpu_torch.data.datasets import synthetic as tsyn
from keras_geometric_tpu_torch.ops import graph_ops as tgo
from keras_geometric_tpu_torch.utils import data_utils as tdu

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "arxiv.zip"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_network(monkeypatch):
    """A loader that tried to download would fail here, not reach out."""
    def refuse(*args, **kwargs):
        raise AssertionError("a test tried to download")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _equal(a, b):
    """Arrays (numpy, jax or torch; None) equal in shape, values and kind.

    A JAX array without x64 holds 64-bit data in 32 bits: the port's array
    is compared at the type JAX would give it.
    """
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(b, torch.Tensor):
        b = b.cpu().numpy()
    b = np.asarray(b)
    if isinstance(a, jax.Array):
        b = b.astype(jax.dtypes.canonicalize_dtype(b.dtype))
    a = np.asarray(a)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# -- padding helpers ---------------------------------------------------------

@pytest.mark.parametrize("e,target,n,transposed", [
    (7, 7, 5, False), (7, 12, 5, False), (7, 12, 5, True), (0, 4, 1, False),
    (3, 9, 0, False)])
def test_pad_edges_matches_reference(e, target, n, transposed):
    ei = np.random.default_rng(e).integers(0, max(n, 1), (2, e))
    ei = ei.T if transposed else ei
    got, want = tgo.pad_edges(ei, target, n), jgo.pad_edges(ei, target, n)
    for a, b in zip(want, got):
        _equal(a, b)
    assert got[0].shape == (2, target) and got[1].sum() == e


@pytest.mark.parametrize("shape,target", [((4, 3), 4), ((4, 3), 9),
                                          ((5,), 8), ((0, 2), 3)])
def test_pad_nodes_matches_reference(shape, target):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got, want = tgo.pad_nodes(x, target), jgo.pad_nodes(x, target)
    for a, b in zip(want, got):
        _equal(a, b)


def test_pad_helpers_refuse_a_smaller_target():
    with pytest.raises(ValueError, match="target_e"):
        tgo.pad_edges(np.zeros((2, 5), np.int32), 4, 3)
    with pytest.raises(ValueError, match="target_n"):
        tgo.pad_nodes(np.zeros((5, 2)), 4)


# -- Graph, GraphData, batching ----------------------------------------------

GRAPH_FIELDS = ("x", "senders", "receivers", "edge_attr", "y", "node_mask",
                "edge_mask", "batch", "n_node", "n_edge")


def _graphs_equal(ref, port):
    for field in GRAPH_FIELDS:
        _equal(getattr(ref, field), getattr(port, field))
    assert ref.num_nodes == port.num_nodes
    assert ref.num_edges == port.num_edges
    assert ref.num_node_features == port.num_node_features
    _equal(ref.edge_index, port.edge_index)


@pytest.mark.parametrize("transposed", [False, True])
def test_graph_from_edge_index_matches_reference(transposed):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    ei = rng.integers(0, 6, (2, 9))
    ei = ei.T if transposed else ei
    attr = rng.standard_normal((9, 2)).astype(np.float32)
    y = rng.integers(0, 3, 6).astype(np.int32)
    ref = jgraph.Graph.from_edge_index(x, ei, edge_attr=attr, y=y)
    port = tgraph.Graph.from_edge_index(x, ei, edge_attr=attr, y=y,
                                        device=CPU)
    _graphs_equal(ref, port)
    with pytest.raises(ValueError, match="rank-2"):
        tgraph.Graph.from_edge_index(x, np.zeros(3), device=CPU)
    with pytest.raises(ValueError, match=r"\[2, E\]"):
        tgraph.Graph.from_edge_index(x, np.zeros((3, 3)), device=CPU)


def test_graph_copies_a_read_only_array(tmp_path):
    np.save(tmp_path / "x.npy", np.ones((3, 2), np.float32))
    x = np.load(tmp_path / "x.npy", mmap_mode="r")
    g = tgraph.Graph.from_edge_index(x, [[0, 1], [1, 2]], device=CPU)
    g.x.add_(1.0)  # writable, and not the map's memory
    assert float(x.sum()) == 6.0 and float(g.x.sum()) == 12.0


def _graph_data(module, seed, n, e, f, *, node_y=False, graph_y=False,
                attr=False, **extras):
    rng = np.random.default_rng(seed)
    kwargs = dict(extras)
    if attr:
        kwargs["edge_attr"] = rng.standard_normal((e, 2)).astype(np.float32)
    if node_y:
        kwargs["y"] = rng.integers(0, 3, (n, 1)).astype(np.int64)
    if graph_y:
        kwargs["y"] = rng.standard_normal(2).astype(np.float32)
    return module.GraphData(
        x=rng.standard_normal((n, f)).astype(np.float32),
        edge_index=rng.integers(0, n, (2, e)), **kwargs)


def _data_equal(ref, port):
    assert type(port).__name__ == "GraphData"
    assert (ref.num_nodes, ref.num_edges, ref.num_node_features,
            ref.num_edge_features) == (port.num_nodes, port.num_edges,
                                       port.num_node_features,
                                       port.num_edge_features)
    rd, pd = ref.to_dict(), port.to_dict()
    assert rd.keys() == pd.keys()
    for key in rd:
        _equal(rd[key], pd[key])
    assert repr(ref) == repr(port)


def test_graph_data_matches_reference():
    for module_kwargs in (dict(attr=True, node_y=True, mask=np.ones(5, bool)),
                          dict(graph_y=True)):
        ref = _graph_data(jdu, 0, 5, 8, 3, **module_kwargs)
        port = _graph_data(tdu, 0, 5, 8, 3, **module_kwargs)
        _data_equal(ref, port)
        assert len(ref.to_inputs()) == len(port.to_inputs())
        for a, b in zip(ref.to_inputs(), port.to_inputs()):
            _equal(a, b)
        _graphs_equal(ref.to_graph(), port.to_graph(device=CPU))
    port = _graph_data(tdu, 0, 5, 8, 3, mask=np.ones(5, bool))
    assert port.mask.dtype == bool
    with pytest.raises(AttributeError, match="no attribute 'missing'"):
        port.missing
    # [E, 2] is transposed; anything else is refused.
    g = tdu.GraphData(np.zeros((3, 1)), np.array([[0, 1], [1, 2], [2, 0]]))
    assert g.edge_index.shape == (2, 3) and g.edge_index.dtype == np.int32
    with pytest.raises(ValueError, match="rank-2"):
        tdu.GraphData(np.zeros((3, 1)), np.zeros(4))


@pytest.mark.parametrize("case", ["node_y", "graph_y", "attr", "plain"])
def test_batch_graphs_matches_reference(case):
    kwargs = {"node_y": dict(node_y=True), "graph_y": dict(graph_y=True),
              "attr": dict(attr=True, node_y=True), "plain": {}}[case]
    sizes = ((4, 6), (1, 0), (5, 9))
    ref = jdu.batch_graphs([_graph_data(jdu, i, n, e, 3, **kwargs)
                            for i, (n, e) in enumerate(sizes)])
    port = tdu.batch_graphs([_graph_data(tdu, i, n, e, 3, **kwargs)
                             for i, (n, e) in enumerate(sizes)])
    _data_equal(ref, port)
    # Offsets: the second graph's edges start at node 4 + 1 = 5.
    assert port.edge_index[:, 6:].min() >= 5
    np.testing.assert_array_equal(port.batch, [0] * 4 + [1] + [2] * 5)


def test_batch_graphs_refuses_an_empty_list():
    for module in (jdu, tdu):
        with pytest.raises(ValueError, match="empty list"):
            module.batch_graphs([])


@pytest.mark.parametrize("buckets", [{}, dict(node_bucket=16, edge_bucket=32),
                                     dict(bucket_multiple=8)])
@pytest.mark.parametrize("case", ["node_y", "graph_y", "attr"])
def test_batch_graphs_padded_matches_reference(buckets, case):
    kwargs = {"node_y": dict(node_y=True), "graph_y": dict(graph_y=True),
              "attr": dict(attr=True, node_y=True)}[case]
    sizes = ((4, 6), (3, 5), (5, 9))
    ref = jdu.batch_graphs_padded(
        [_graph_data(jdu, i, n, e, 3, **kwargs)
         for i, (n, e) in enumerate(sizes)], **buckets)
    port = tdu.batch_graphs_padded(
        [_graph_data(tdu, i, n, e, 3, **kwargs)
         for i, (n, e) in enumerate(sizes)], **buckets, device=CPU)
    _graphs_equal(ref, port)
    assert int(port.n_node) == 12 and int(port.n_edge) == 20


def test_batch_graphs_padded_refuses_a_small_bucket():
    graphs = [_graph_data(tdu, 0, 5, 8, 3)]
    with pytest.raises(ValueError, match="smaller than batch"):
        tdu.batch_graphs_padded(graphs, node_bucket=4, device=CPU)


# -- synthetic generators ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kwargs", [dict(num_classes=5), dict(symmetric=False),
                                    dict(dtype=np.float64)],
                         ids=["classes", "directed", "f64"])
def test_synthetic_graph_is_bit_equal(seed, kwargs):
    ref = jsyn.synthetic_graph(40, 120, 6, seed=seed, **kwargs)
    port = tsyn.synthetic_graph(40, 120, 6, seed=seed, **kwargs)
    _data_equal(ref, port)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", ["cora", "citeseer", "PubMed"])
def test_synthetic_planetoid_is_bit_equal(name, seed):
    ref = jsyn.synthetic_planetoid(name, seed=seed)
    port = tsyn.synthetic_planetoid(name, seed=seed)
    _data_equal(ref, port)
    assert port.num_nodes == tsyn.PLANETOID_STATS[name.lower()][0]
    assert not (port.train_mask & port.test_mask).any()


def test_synthetic_planetoid_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="Unknown planetoid"):
        tsyn.synthetic_planetoid("reddit")


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kwargs", [{}, dict(symmetric=False,
                                             drop_self_loops=False)],
                         ids=["symmetric", "directed_loops"])
def test_rmat_edges_are_bit_equal(seed, kwargs):
    _equal(jsyn.rmat_edges(9, 3000, seed=seed, **kwargs),
           tsyn.rmat_edges(9, 3000, seed=seed, **kwargs))


def test_datasets_exports_match_reference():
    assert set(jds.__all__) <= set(tds.__all__)
    assert set(tds.__all__) - set(jds.__all__) == {"community_graph"}


# -- the processed cache -----------------------------------------------------

class _ReadOnly:
    def _download(self):
        raise AssertionError("the cache should have been read")

    def _load(self):
        raise AssertionError("the cache should have been read")


def _dataset_classes(base_module, data_module):
    class Tiny(base_module.Dataset):
        def _download(self):
            pass

        def _load(self):
            return [_graph_data(data_module, i, 4 + i, 6, 3, attr=True,
                                node_y=True, split=np.arange(4 + i) % 3)
                    for i in range(3)], 3

    class Reader(_ReadOnly, base_module.Dataset):
        pass

    return Tiny, Reader


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dataset_cache_is_read_by_the_other_package(tmp_path, writer):
    packages = {"reference": (jbase, jdu), "port": (tbase, tdu)}
    reader = "port" if writer == "reference" else "reference"
    w_cls, _ = _dataset_classes(*packages[writer])
    _, r_cls = _dataset_classes(*packages[reader])
    written = w_cls(root=str(tmp_path), name="tiny")
    read = r_cls(root=str(tmp_path), name="tiny")
    assert len(written) == len(read) == 3
    assert written.num_classes == read.num_classes == 3
    for i in range(3):
        _data_equal(written[i], read[i])
    for a, b in zip(written.split(0.4, 0.3, seed=2), read.split(0.4, 0.3,
                                                                seed=2)):
        assert [g.num_nodes for g in a] == [g.num_nodes for g in b]


def test_dataset_transforms_and_split_match_reference(tmp_path):
    t_cls, _ = _dataset_classes(tbase, tdu)
    j_cls, _ = _dataset_classes(jbase, jdu)
    pre = lambda g: type(g)(x=g.x * 2, edge_index=g.edge_index, y=g.y)
    port = t_cls(root=str(tmp_path / "t"), name="tiny", pre_transform=pre,
                 transform=lambda g: type(g)(x=g.x + 1, edge_index=g.edge_index))
    ref = j_cls(root=str(tmp_path / "j"), name="tiny", pre_transform=pre,
                transform=lambda g: type(g)(x=g.x + 1, edge_index=g.edge_index))
    for i in range(3):
        _data_equal(ref[i], port[i])
    for shuffle in (True, False):
        for a, b in zip(ref.split(shuffle=shuffle), port.split(shuffle=shuffle)):
            assert [g.num_nodes for g in a] == [g.num_nodes for g in b]


def test_download_error_names_the_ports_synthetic_generator(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(tbase.time, "sleep", lambda s: None)

    def offline(*args, **kwargs):
        raise OSError("offline")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    with pytest.raises(RuntimeError) as err:
        tbase.download_url("https://example.invalid/x", str(tmp_path / "x"))
    assert "after 3 attempts" in str(err.value)
    assert ("keras_geometric_tpu_torch.data.datasets.synthetic_planetoid()"
            in str(err.value))
    kept = tmp_path / "kept"
    kept.write_text("here")
    assert tbase.download_url("https://example.invalid/y", str(kept)) == str(
        kept)


# -- Cora / CiteSeer / PubMed on tiny raw files ------------------------------

def _write_cora(root: pathlib.Path):
    raw = root / "cora" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    ids = [31336, 1061127, 1106406, 13195, 37879, 1126012, 1107140]
    labels = ["Neural_Networks", "Rule_Learning", "Theory", "Theory",
              "Case_Based", "Neural_Networks", "Genetic_Algorithms"]
    content = io.StringIO()
    for node, label in zip(ids, labels):
        words = "\t".join(str(int(w)) for w in rng.random(6) < 0.4)
        content.write(f"{node}\t{words}\t{label}\n")
    cites = io.StringIO()
    for a, b in ((0, 1), (1, 2), (3, 0), (4, 5), (6, 2), (2, 6)):
        cites.write(f"{ids[a]}\t{ids[b]}\n")
    cites.write("999\t31336\n")  # a citation of an unknown paper is dropped
    with tarfile.open(raw / "cora.tgz", "w:gz") as tar:
        for name, text in (("cora/cora.content", content.getvalue()),
                           ("cora/cora.cites", cites.getvalue())):
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def test_cora_parses_identical_raw_files(tmp_path):
    for side in ("ref", "port"):
        _write_cora(tmp_path / side)
    ref = jds.CoraDataset(root=str(tmp_path / "ref"))
    port = tds.CoraDataset(root=str(tmp_path / "port"))
    assert ref.num_classes == port.num_classes == 5
    _data_equal(ref[0], port[0])
    assert port[0].num_edges == 12 and port[0].x.shape == (7, 6)
    # The port reads the reference's cache back.
    _data_equal(ref[0], tds.CoraDataset(root=str(tmp_path / "ref"))[0])


def _write_planetoid(root: pathlib.Path, name: str):
    raw = root / name / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(1)
    n_all, n_test, f, c = 6, 3, 5, 3
    onehot = lambda k: np.eye(c)[rng.integers(0, c, k)]
    files = {
        "x": sp.csr_matrix(rng.random((4, f)) < 0.5, dtype=np.float32),
        "y": onehot(4),
        "allx": sp.csr_matrix(rng.random((n_all, f)) < 0.5, dtype=np.float32),
        "ally": onehot(n_all),
        "tx": sp.csr_matrix(rng.random((n_test, f)) < 0.5, dtype=np.float32),
        "ty": onehot(n_test),
        "graph": {0: [1, 2], 1: [0], 3: [4, 8], 5: [5], 7: [6, 2]},
    }
    for key, value in files.items():
        with open(raw / f"ind.{name}.{key}.pkl", "wb") as fh:
            pickle.dump(value, fh)
    # The test block comes shuffled: its rows belong to nodes 8, 6, 7.
    (raw / f"ind.{name}.test.index").write_text("8\n6\n7\n")


@pytest.mark.parametrize("cls", ["CiteSeerDataset", "PubMedDataset"])
def test_citation_parses_identical_raw_files(tmp_path, cls):
    name = {"CiteSeerDataset": "citeseer", "PubMedDataset": "pubmed"}[cls]
    for side in ("ref", "port"):
        _write_planetoid(tmp_path / side, name)
    ref = getattr(jds, cls)(root=str(tmp_path / "ref"))
    port = getattr(tds, cls)(root=str(tmp_path / "port"))
    assert ref.num_classes == port.num_classes == 3
    _data_equal(ref[0], port[0])
    ei = port[0].edge_index
    pairs = list(zip(ei[0].tolist(), ei[1].tolist()))
    assert pairs == sorted(set(pairs))  # sorted, deduplicated, symmetric
    assert all((b, a) in pairs for a, b in pairs)
    with pytest.raises(ValueError, match="not available"):
        tds.CitationDataset(str(tmp_path), "cora")


# -- OGB ---------------------------------------------------------------------

def _ogb_from_fixture(module, root: pathlib.Path):
    (root / "ogbn_arxiv").mkdir(parents=True)
    shutil.copy(FIXTURE, root / "ogbn_arxiv" / "arxiv.zip")
    return module.OGBNodeDataset("ogbn-arxiv", root=str(root))


def _ogb_equal(ref, port, rows=slice(None)):
    for attr in ("num_nodes", "num_edges", "num_feats", "num_classes",
                 "is_synthetic"):
        assert getattr(ref, attr) == getattr(port, attr), attr
    _equal(ref.row_ptr, port.row_ptr)
    for a, b in zip(ref.edges(), port.edges()):
        _equal(a[rows], b[rows])
    _equal(ref.x[rows], port.x[rows])
    _equal(ref.y[rows], port.y[rows])
    rs, ps = ref.split_idx(), port.split_idx()
    assert rs.keys() == ps.keys()
    for key in rs:
        _equal(rs[key], ps[key])


def test_ogb_parses_the_fixture_zip_as_the_reference(tmp_path):
    ref = _ogb_from_fixture(jds, tmp_path / "ref")
    port = _ogb_from_fixture(tds, tmp_path / "port")
    _ogb_equal(ref, port)
    assert not port.is_synthetic and port.num_edges == 24
    for parts in (1, 2, 3):
        for part in range(parts):
            a, b = ref.load_partition(part, parts), port.load_partition(part,
                                                                        parts)
            _equal(a.senders, b.senders)
            _equal(a.receivers, b.receivers)
            assert (a.row_range, a.edge_offset) == (b.row_range,
                                                    b.edge_offset)
    # Either package reads the other's cache.
    _ogb_equal(ref, tds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path / "ref")))
    _ogb_equal(jds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path / "port")),
               port)


def test_ogb_parses_csvs_without_pandas_as_with_it(tmp_path, monkeypatch):
    with_pandas = _ogb_from_fixture(tds, tmp_path / "pandas")
    import builtins

    real_import = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name == "pandas":
            raise ImportError("no pandas")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    without = _ogb_from_fixture(tds, tmp_path / "loadtxt")
    monkeypatch.undo()
    _ogb_equal(with_pandas, without)


def test_ogb_coalesces_and_drops_the_diagonal(tmp_path):
    """Reciprocal raw pairs are stored once each way; raw self-loops go."""
    raw = tmp_path / "ogbn_arxiv" / "raw"
    raw.mkdir(parents=True)
    split = tmp_path / "ogbn_arxiv" / "split" / "time"
    split.mkdir(parents=True)

    def write(path, rows, fmt):
        with gzip.open(path, "wt") as fh:
            for row in rows:
                fh.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")

    write(raw / "edge.csv.gz", [(0, 1), (1, 0), (2, 2), (3, 1), (0, 1)], "%d")
    write(raw / "node-feat.csv.gz", np.arange(8.0).reshape(4, 2), "%.1f")
    write(raw / "node-label.csv.gz", [1, 0, 2, 1], "%d")
    for part, ids in (("train", [0, 1]), ("valid", [2]), ("test", [3])):
        write(split / f"{part}.csv.gz", ids, "%d")
    port = tds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path))
    s, r = port.edges()
    assert sorted(zip(s.tolist(), r.tolist())) == [(0, 1), (1, 0), (1, 3),
                                                   (3, 1)]
    ref = jds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path))
    _ogb_equal(ref, port)


def test_ogb_missing_raw_names_the_synthetic_option(tmp_path):
    with pytest.raises(RuntimeError, match="synthetic=True"):
        tds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path), synthetic=False)
    with pytest.raises(ValueError, match="Unknown OGB dataset"):
        tds.OGBNodeDataset("ogbn-papers100M", root=str(tmp_path))


def test_ogb_reads_the_tracked_arxiv_cache_as_the_reference():
    data = ROOT / "data"
    meta = (data / "ogbn_arxiv" / "meta.json").stat().st_mtime_ns
    ref = jds.OGBNodeDataset("ogbn-arxiv", root=str(data))
    port = tds.OGBNodeDataset("ogbn-arxiv", root=str(data))
    assert (port.num_nodes, port.num_edges, port.num_feats,
            port.num_classes) == tds.OGB_STATS["ogbn-arxiv"]
    assert port.is_synthetic
    for rows in (slice(0, 1000), slice(-1000, None), slice(777_777, 779_000)):
        _ogb_equal(ref, port, rows=rows)
    for part in (0, 3):
        a, b = ref.load_partition(part, 4), port.load_partition(part, 4)
        _equal(a.senders, b.senders)
        assert (a.row_range, a.edge_offset) == (b.row_range, b.edge_offset)
    # Nothing was written into the tracked directory.
    assert (data / "ogbn_arxiv" / "meta.json").stat().st_mtime_ns == meta
    assert sorted(p.name for p in (data / "ogbn_arxiv").iterdir()) == [
        "meta.json", "receivers.npy", "row_ptr.npy", "senders.npy",
        "split.npz", "x.npy", "y.npy"]


def test_ogb_synthetic_prepare_rebuilds_the_tracked_cache(tmp_path):
    """The port's synthetic stand-in, seed 0, is the tracked cache bit for
    bit (the reference's prepare wrote it)."""
    port = tds.OGBNodeDataset("ogbn-arxiv", root=str(tmp_path), synthetic=True)
    tracked = tds.OGBNodeDataset("ogbn-arxiv", root=str(ROOT / "data"))
    assert port.is_synthetic
    for name in ("x", "y", "senders", "receivers", "row_ptr"):
        a = np.load(tmp_path / "ogbn_arxiv" / f"{name}.npy", mmap_mode="r")
        b = np.load(ROOT / "data" / "ogbn_arxiv" / f"{name}.npy",
                    mmap_mode="r")
        _equal(b, a)
    a, b = port.split_idx(), tracked.split_idx()
    for key in b:
        _equal(b[key], a[key])
