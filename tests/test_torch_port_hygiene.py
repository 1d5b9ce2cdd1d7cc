"""Hygiene of the PyTorch port: it stands beside the JAX package and imports
none of it; its kernel wrappers take the plain version only for CPU tensors;
its entry points default to the CUDA device.
"""

import importlib.util
import inspect
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import keras_geometric_tpu_torch as kgt_torch
from keras_geometric_tpu_torch import native
from keras_geometric_tpu_torch.kernels import (
    _build,
    attend_cuda,
    band_cuda,
    sddmm_cuda,
    softmax_cuda,
    spmm_cuda,
)
from keras_geometric_tpu_torch.ops import spmm as spmm_ops
from keras_geometric_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "keras_geometric_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "attend_kernels_ab.py",
    ROOT / "distributed_host_probe.py", ROOT / "tp_activation_probe.py",
    ROOT / "tools" / "accuracy_check_torch.py"] + \
    sorted((ROOT / "examples_torch").glob("*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+optax|from\s+optax"
    r"|(import|from)\s+keras_geometric_tpu(?!_torch)\b)", re.M)

MODULES = [
    "_version.py", "__init__.py", "native.py", "convert.py",
    "kernels/spmm_cuda.py", "kernels/_build.py", "kernels/csrc/spmm.cu",
    "ops/segment.py", "ops/graph_ops.py", "ops/spmm.py", "ops/csr.py",
    "ops/precompute.py", "nn/module.py", "nn/gcn_conv.py", "models/gnn.py",
    "training/train.py", "utils/profiling.py",
    "kernels/attend_cuda.py", "kernels/csrc/attend.cu", "ops/edge_dropout.py",
    "nn/gatv2_conv.py",
    "kernels/softmax_cuda.py", "kernels/csrc/softmax.cu",
    "kernels/sddmm_cuda.py", "kernels/csrc/sddmm.cu", "kernels/csrc/lanes.cuh",
    "kernels/band_cuda.py", "kernels/csrc/band.cu", "ops/reorder.py",
    "data/__init__.py", "data/datasets/__init__.py",
    "data/datasets/synthetic.py",
    "kernels/csrc/segment_max.cu", "nn/aggregators.py",
    "nn/message_passing.py", "nn/gin_conv.py", "nn/sage_conv.py",
    "graph.py", "utils/__init__.py", "utils/data_utils.py",
    "data/sampling.py", "data/datasets/base.py", "data/datasets/cora.py",
    "data/datasets/citation.py", "data/datasets/ogb.py",
    "training/__init__.py", "training/metrics.py", "training/checkpoint.py",
    "training/sage_minibatch.py",
    "nn/pooling/__init__.py", "nn/pooling/global_pooling.py",
    "nn/pooling/attention_pooling.py", "models/__init__.py",
    "utils/device.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/partition.py",
    "parallel/halo.py", "parallel/kernel_plan.py", "parallel/attend_plan.py",
    "parallel/spmd.py", "parallel/distributed.py",
    "parallel/tensor_parallel.py", "parallel/data_parallel.py",
]
# The data tier and minibatch training: the modules it added or extended.
DATA_TIER_MODULES = [
    "graph.py", "utils/data_utils.py", "utils/__init__.py",
    "ops/graph_ops.py", "native.py", "data/__init__.py",
    "data/sampling.py", "data/datasets/__init__.py",
    "data/datasets/base.py", "data/datasets/synthetic.py",
    "data/datasets/cora.py", "data/datasets/citation.py",
    "data/datasets/ogb.py", "training/train.py", "training/metrics.py",
    "training/checkpoint.py", "training/sage_minibatch.py",
    "training/__init__.py", "__init__.py",
]
# The graph-level readout and the modules it added or extended.
READOUT_MODULES = [
    "nn/pooling/__init__.py", "nn/pooling/global_pooling.py",
    "nn/pooling/attention_pooling.py", "nn/module.py", "nn/__init__.py",
    "models/gnn.py", "models/__init__.py", "ops/__init__.py", "convert.py",
]
# Partitioned full-graph training: the distribution tier's modules.
PARALLEL_MODULES = [
    "parallel/__init__.py", "parallel/mesh.py", "parallel/partition.py",
    "parallel/halo.py", "parallel/kernel_plan.py", "parallel/attend_plan.py",
    "parallel/spmd.py", "parallel/distributed.py",
    "parallel/tensor_parallel.py", "parallel/data_parallel.py",
]
# The reference's top-level names the port does not have (none since the
# graph-level readout landed); and the port's own additions.
M8_NAMES = set()
PORT_ADDITIONS = {"GNNEncoder", "GCN", "GIN", "GAT", "GraphSAGE",
                  "GraphContext", "prepare_graph", "precompute_propagation"}


@pytest.mark.parametrize("rel", MODULES)
def test_slice_module_exists(rel):
    assert (PORT / rel).is_file()


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_and_no_reference_package_imports(path):
    text = path.read_text()
    assert not FORBIDDEN.search(text), path
    # The reference package is not even named: its name only ever appears
    # followed by the port's "_torch".
    assert not re.search(r"keras_geometric_tpu[^_]", text), path


def test_importing_the_port_does_not_import_jax():
    code = (
        "import sys\n"
        "import keras_geometric_tpu_torch as k\n"
        "import keras_geometric_tpu_torch.training, "
        "keras_geometric_tpu_torch.convert, "
        "keras_geometric_tpu_torch.utils, "
        "keras_geometric_tpu_torch.kernels.spmm_cuda, "
        "keras_geometric_tpu_torch.kernels.attend_cuda, "
        "keras_geometric_tpu_torch.kernels.softmax_cuda, "
        "keras_geometric_tpu_torch.kernels.sddmm_cuda, "
        "keras_geometric_tpu_torch.nn.gatv2_conv, "
        "keras_geometric_tpu_torch.ops.edge_dropout, "
        "keras_geometric_tpu_torch.kernels.band_cuda, "
        "keras_geometric_tpu_torch.ops.reorder, "
        "keras_geometric_tpu_torch.data.datasets, "
        "keras_geometric_tpu_torch.nn.pooling, "
        "keras_geometric_tpu_torch.models\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'keras_geometric_tpu' or "
        "m.startswith('keras_geometric_tpu.') or m == 'optax']\n"
        "assert not bad, bad\n"
        "print(k.__version__)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == kgt_torch.__version__


def _imports_neither_jax_nor_the_reference(rel):
    path = PORT / rel
    assert path.is_file()
    text = path.read_text()
    assert not FORBIDDEN.search(text), rel
    assert not re.search(r"keras_geometric_tpu[^_]", text), rel
    name = "keras_geometric_tpu_torch." + rel[:-3].replace("/", ".")
    module = importlib.import_module(name.removesuffix(".__init__"))
    assert module.__name__.startswith("keras_geometric_tpu_torch")


@pytest.mark.parametrize("rel", DATA_TIER_MODULES)
def test_data_tier_module_imports_neither_jax_nor_the_reference(rel):
    _imports_neither_jax_nor_the_reference(rel)


@pytest.mark.parametrize("rel", READOUT_MODULES)
def test_readout_module_imports_neither_jax_nor_the_reference(rel):
    _imports_neither_jax_nor_the_reference(rel)


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_parallel_module_imports_neither_jax_nor_the_reference(rel):
    _imports_neither_jax_nor_the_reference(rel)


def test_make_mesh_needs_a_process_group_and_defaults_to_cuda():
    """Without a process group and without a torchrun environment the
    distribution tier raises: it never starts a CPU or gloo group of its own
    accord; its mesh and shards default to the card."""
    from keras_geometric_tpu_torch.parallel import mesh as par_mesh

    assert not torch.distributed.is_initialized()
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="process group"):
            par_mesh.make_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            par_mesh.make_mesh()
    finally:
        os.environ.update(env)
    assert not torch.distributed.is_initialized()
    default = inspect.signature(par_mesh.make_mesh).parameters["device_type"]
    assert default.default == "cuda"


def test_importing_the_data_tier_loads_no_build_and_no_jax():
    code = (
        "import sys, torch\n"
        "import keras_geometric_tpu_torch.data.sampling, "
        "keras_geometric_tpu_torch.data.datasets, "
        "keras_geometric_tpu_torch.training, "
        "keras_geometric_tpu_torch.training.sage_minibatch, "
        "keras_geometric_tpu_torch.utils, keras_geometric_tpu_torch.graph\n"
        "from keras_geometric_tpu_torch.kernels import _build\n"
        "assert _build.BUILD_SECONDS == {}, _build.BUILD_SECONDS\n"
        "assert _build.load_library.cache_info().currsize == 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'orbax', 'keras_geometric_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_package_exports_differ_from_the_reference_by_the_readout_only():
    ref = importlib.import_module("keras_geometric_tpu")
    assert set(ref.__all__) - set(kgt_torch.__all__) == M8_NAMES
    assert set(kgt_torch.__all__) - set(ref.__all__) == PORT_ADDITIONS
    for name in kgt_torch.__all__:
        assert hasattr(kgt_torch, name), name
    for sub in ("training", "utils", "data.datasets", "ops", "nn", "models",
                "parallel"):
        ref_sub = importlib.import_module(f"keras_geometric_tpu.{sub}")
        port_sub = importlib.import_module(f"keras_geometric_tpu_torch.{sub}")
        assert set(ref_sub.__all__) <= set(port_sub.__all__), sub
        if sub == "parallel":
            assert set(port_sub.__all__) == set(ref_sub.__all__)
    classes = kgt_torch.get_dataset_classes()
    assert sorted(classes) == sorted(ref.get_dataset_classes())
    ei = np.array([[0, 1, 2], [1, 2, 0]])
    np.testing.assert_allclose(
        kgt_torch.compute_gcn_normalization(ei, 3).numpy(),
        np.asarray(ref.compute_gcn_normalization(ei, 3)), rtol=1e-6)


@pytest.mark.parametrize("sub", ["tensor_parallel", "data_parallel"])
def test_parallel_modules_export_the_references_names(sub):
    """The distribution tier's last two modules: each ``__all__`` is the
    reference module's, in its order, and the package has every name."""
    ref = importlib.import_module(f"keras_geometric_tpu.parallel.{sub}")
    port = importlib.import_module(f"keras_geometric_tpu_torch.parallel.{sub}")
    assert port.__all__ == ref.__all__
    package = importlib.import_module("keras_geometric_tpu_torch.parallel")
    for name in port.__all__:
        assert getattr(package, name) is getattr(port, name), name


# The keyword renames that the port's recorded divergences allow (ROADMAP.md
# Queue 3), one named entry each: (the reference modules whose functions and
# classes it covers, the reference's keyword names, the port's). A reference
# keyword that the port lacks, or a required keyword of the port's own, passes
# only where an entry names it for the module that defines the callable.
_NN = "keras_geometric_tpu.nn."
_PAR = "keras_geometric_tpu.parallel."
SIGNATURE_RENAMES = {
    "D6/D17: rng / key -> torch.Generator": (
        {_NN + "module", "keras_geometric_tpu.ops.edge_dropout",
         "keras_geometric_tpu.training.train", _PAR + "spmd",
         _PAR + "attend_plan"},
        {"rng", "key"}, {"generator"}),
    "D17/D18: axis -> group": (
        {_PAR + "tensor_parallel", _PAR + "kernel_plan", _PAR + "attend_plan",
         _PAR + "halo", _PAR + "spmd"},
        {"axis", "graph_axis", "model_axis", "host_axis", "chip_axis"},
        {"group", "graph_group", "model_group", "host_group", "chip_group"}),
    "D16-D18: params -> modules: a layer is built with its input_dim": (
        {_NN + "module", _NN + "gcn_conv", _NN + "gatv2_conv",
         _NN + "gin_conv", _NN + "sage_conv", _NN + "aggregators",
         _NN + "pooling.attention_pooling", "keras_geometric_tpu.models.gnn"},
        set(), {"input_dim"}),
    "D16-D18: tx / donate / params -> modules and torch.optim": (
        {"keras_geometric_tpu.training.train",
         "keras_geometric_tpu.training.sage_minibatch", _PAR + "distributed",
         _PAR + "data_parallel", _PAR + "spmd"},
        {"tx", "donate", "params", "opt_state"}, {"optimizer", "model"}),
    "D7/D17: work-list tables / edge_chunk / row_block -> row_ptr": (
        {"keras_geometric_tpu.ops.csr", "keras_geometric_tpu.ops.spmm",
         _PAR + "kernel_plan", _PAR + "attend_plan"},
        {"tables", "fwd_tables", "bwd_tables", "expand_tables",
         "attw_res_tables", "edge_chunk", "row_block", "scatter_row_block",
         "expand_row_block", "use_pallas"},
        {"row_ptr", "row_ptr_bwd"}),
    "D17: a rank's data is its slice; a mesh is a DeviceMesh": (
        {_PAR + "spmd", _PAR + "attend_plan", _PAR + "kernel_plan",
         _PAR + "halo", _PAR + "mesh", _PAR + "distributed"},
        {"senders_global", "receivers_local", "send_idx_local", "kp_shard",
         "kp_meta", "ap_meta", "training", "halo", "kernel_plan",
         "attend_plan", "devices"},
        {"senders", "receivers", "send_idx", "kp", "shard", "part",
         "device"}),
}
# Defaults the port writes in its own library's terms: (the reference's
# default, the port's), compared by ``_default_key``.
SIGNATURE_DEFAULTS = {
    "jnp.float32 -> torch.float32": ("float32", "float32"),
    "jax.nn.relu -> torch.relu": ("relu", "relu"),
    "D19: Roofline's chip": ("'v5e'", "'h100'"),
}
# Reference names with no counterpart: TPU-only (F3), or a host plan the
# port lays out its own way (D17: its streams are ``EdgeStream`` and its
# ``KernelPlan`` / ``AttendPlan`` hold row pointers, not work lists).
SIGNATURE_NOT_PORTED = {"chain_after", "use_pallas_default", "graph_sharding",
                        "replicated", "P", "Mesh", "EdgeSetShard"}
SIGNATURE_OWN_LAYOUT = {"KernelPlan", "AttendPlan"}
SIGNATURE_NOT_PORTED_MODULES = {
    "keras_geometric_tpu.utils.interpret_hardening"}


def _default_key(value):
    """A default in terms both packages share: a dtype by its name, a
    function by its name (the port's function of the same name), anything
    else by its repr."""
    name = getattr(value, "__name__", None)
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if name is not None and isinstance(value, type):
        return name  # jnp.float32 and the like are types
    if name is not None and callable(value):
        return name
    return repr(value)


def _renames_for(module: str) -> tuple:
    """The reference keyword names and the port's that the entries naming
    ``module`` allow."""
    entries = [(r, p) for scope, r, p in SIGNATURE_RENAMES.values()
               if module in scope]
    return (set().union(*(r for r, _ in entries)),
            set().union(*(p for _, p in entries)))


def _signature_faults(ref_obj, port_obj):
    """The differences between two public callables' keywords that no
    recorded divergence of the reference callable's module explains."""
    try:
        ref_sig = inspect.signature(ref_obj)
        port_sig = inspect.signature(port_obj)
    except (TypeError, ValueError):
        return []
    plain = lambda sig: {k: p for k, p in sig.parameters.items()
                         if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    rp, pp = plain(ref_sig), plain(port_sig)
    renamed_from, renamed_to = _renames_for(ref_obj.__module__)
    faults = [f"lacks {k}" for k in rp.keys() - pp.keys()
              if k not in renamed_from]
    faults += [f"requires {k}" for k in pp.keys() - rp.keys()
               if pp[k].default is inspect.Parameter.empty
               and k not in renamed_to]
    for k in rp.keys() & pp.keys():
        ref_default, port_default = rp[k].default, pp[k].default
        if ref_default is inspect.Parameter.empty:
            continue  # a default the port adds breaks no reference call
        pair = (_default_key(ref_default), _default_key(port_default))
        if pair[0] != pair[1] and pair not in SIGNATURE_DEFAULTS.values():
            faults.append(f"{k}={pair[1]} (reference {pair[0]})")
    return faults


@pytest.mark.parametrize("sub", ["", "data", "ops", "nn", "models",
                                 "training", "utils", "parallel"])
def test_public_signatures_match_the_references(sub):
    """Every public function and class of the sub-package and of its modules
    (each ``__all__``) takes the reference's keyword names with the
    reference's defaults, apart from the renames that the recorded
    divergences allow (``SIGNATURE_RENAMES``, ``SIGNATURE_DEFAULTS``)."""
    import pkgutil

    ref_pkg = importlib.import_module(
        "keras_geometric_tpu" + (f".{sub}" if sub else ""))
    if sub:
        modules = [ref_pkg.__name__] + [
            m.name for m in pkgutil.walk_packages(
                ref_pkg.__path__, ref_pkg.__name__ + ".")]
    else:  # the package and its top-level modules
        modules = [ref_pkg.__name__] + [
            m.name for m in pkgutil.iter_modules(
                ref_pkg.__path__, ref_pkg.__name__ + ".") if not m.ispkg]
    faults, compared = [], 0
    for ref_name in modules:
        ref_mod = importlib.import_module(ref_name)
        if ref_name in SIGNATURE_NOT_PORTED_MODULES or not hasattr(
                ref_mod, "__all__"):
            continue
        port_mod = importlib.import_module(ref_name.replace(
            "keras_geometric_tpu", "keras_geometric_tpu_torch", 1))
        for name in ref_mod.__all__:
            ref_obj = getattr(ref_mod, name)
            if not callable(ref_obj) or name in SIGNATURE_NOT_PORTED:
                continue
            port_obj = getattr(port_mod, name, None)
            if port_obj is None:
                faults.append(f"{ref_name}.{name}: missing")
                continue
            if name in SIGNATURE_OWN_LAYOUT:
                continue
            compared += 1
            faults += [f"{ref_name}.{name}: {f}"
                       for f in _signature_faults(ref_obj, port_obj)]
    assert compared > 0
    assert not faults, faults


def _fake_callable(module: str, keywords, default):
    """A function of ``module`` taking ``x`` and the keyword-only
    ``keywords``, each with ``default``."""
    P = inspect.Parameter
    fn = lambda *args, **kwargs: None
    fn.__module__ = module
    fn.__signature__ = inspect.Signature(
        [P("x", P.POSITIONAL_OR_KEYWORD)]
        + [P(k, P.KEYWORD_ONLY, default=default) for k in sorted(keywords)])
    return fn


@pytest.mark.parametrize("entry", list(SIGNATURE_RENAMES))
def test_each_signature_rename_holds_only_in_its_modules(entry):
    """A rename passes for a callable of a module that its entry names, and
    is a fault in a module that it does not name: in ``ops.graph_ops``,
    which no entry names, and in the layers' module ``nn.gcn_conv`` unless
    the entry names it."""
    scope, renamed_from, renamed_to = SIGNATURE_RENAMES[entry]
    every = {f"lacks {k}" for k in renamed_from} | {
        f"requires {k}" for k in renamed_to}
    faults = lambda module: set(_signature_faults(
        _fake_callable(module, renamed_from, None),
        _fake_callable(module, renamed_to, inspect.Parameter.empty)))
    for module in scope:
        assert faults(module) == set(), module
    outside = "keras_geometric_tpu.ops.graph_ops"
    assert all(outside not in s for s, _, _ in SIGNATURE_RENAMES.values())
    assert faults(outside) == every
    layer = _NN + "gcn_conv"
    if layer not in scope:
        allowed_from, allowed_to = _renames_for(layer)
        allowed = {f"lacks {k}" for k in allowed_from} | {
            f"requires {k}" for k in allowed_to}
        assert faults(layer) == every - allowed
        assert faults(layer), entry


def test_importing_builds_and_loads_nothing():
    """Kernels are built at first use on a CUDA tensor, never at import."""
    assert _build.BUILD_SECONDS == {}
    assert _build.load_library.cache_info().currsize == 0


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    spmm_cuda.reset_launch_counts()
    recv = torch.tensor([0, 0, 2, 3, 3], dtype=torch.int32)
    idx = torch.tensor([1, 2, 0, 3, 1], dtype=torch.int32)
    w = torch.tensor([1.0, 0.5, 2.0, 1.0, 0.0])
    msgs = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    rows = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    row_ptr = spmm_cuda.row_ptr_from_sorted(recv, 4)

    out = spmm_cuda.scatter_sum_sorted(msgs, recv, 4, weights=w)
    assert torch.equal(out, spmm_cuda.scatter_sum_sorted_plain(
        msgs, recv, 4, weights=w))
    np.testing.assert_allclose(out.numpy(), [[1, 2.5], [0, 0], [8, 10], [6, 7]])

    out = spmm_cuda.expand_sorted(rows, recv, weights=w)
    assert torch.equal(out, spmm_cuda.expand_sorted_plain(rows, recv, weights=w))

    out = spmm_cuda.gather_scatter_sum_sorted(rows, idx, recv, row_ptr, 4,
                                              weights=w)
    assert torch.equal(out, spmm_cuda.gather_scatter_sum_sorted_plain(
        rows, idx, recv, 4, weights=w))
    assert spmm_cuda.LAUNCH_COUNTS == {
        "scatter_sum_sorted": 0, "gather_scatter_sum_sorted": 0,
        "expand_sorted": 0, "segment_max_sorted": 0,
        "segment_max_wide_sorted": 0, "segment_max_wide_bwd": 0}
    assert _build.load_library.cache_info().currsize == 0


def test_segment_max_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    spmm_cuda.reset_launch_counts()
    recv = torch.tensor([0, 0, 2, 3, 3, 3], dtype=torch.int32)
    row_ptr = spmm_cuda.row_ptr_from_sorted(recv, 5)
    mask = torch.tensor([True] * 5 + [False])
    scores = torch.tensor([[1.0, -2.0], [3.0, -4.0], [5.0, 0.0], [2.0, 2.0],
                           [2.0, 1.0], [9.0, 9.0]])
    got = spmm_cuda.segment_max_sorted(scores, recv, 5, row_ptr=row_ptr,
                                       mask=mask)
    assert torch.equal(got, spmm_cuda.segment_max_sorted_plain(
        scores, recv, 5, mask=mask))
    assert got[3].tolist() == [2.0, 2.0] and torch.isinf(got[1]).all()
    raw = spmm_cuda.segment_max_wide_raw(scores, 5, row_ptr=row_ptr,
                                         mask=mask)
    assert torch.equal(raw, spmm_cuda.segment_max_wide_raw_plain(
        scores, recv, 5, mask=mask))
    assert (raw[1] == spmm_cuda.NEG_SENTINEL).all()
    msgs = scores.clone().requires_grad_()
    out = spmm_cuda._segment_max_sorted_split(msgs, recv, 5, row_ptr=row_ptr,
                                              mask=mask)
    assert not out[1].any() and not out[4].any()  # empty rows are 0
    out.sum().backward()
    assert msgs.grad[3:5, 0].tolist() == [0.5, 0.5]  # a tie, split
    assert msgs.grad[5].tolist() == [0.0, 0.0]  # the masked slot
    assert not any(spmm_cuda.LAUNCH_COUNTS.values())
    assert not any(spmm_cuda.MODE_LAUNCH_COUNTS.values())
    assert _build.load_library.cache_info().currsize == 0


def test_segment_max_wrappers_branch_on_the_tensor_device_only():
    for fn, data, counter in (
            (spmm_cuda._segment_max_narrow, "scores", "segment_max_sorted"),
            (spmm_cuda._segment_max_wide_fwd, "messages",
             "segment_max_wide_sorted"),
            (spmm_cuda._segment_max_wide_bwd, "messages",
             "segment_max_wide_bwd")):
        body = inspect.getsource(fn)
        assert re.search(
            rf"if not {data}\.is_cuda:\n\s+return \w+_plain\(", body)
        assert body.count("_plain(") == 1
        assert f'LAUNCH_COUNTS["{counter}"] += 1' in body
    # The public functions and the layers reach the kernels through the
    # wrappers only, and a CUDA tensor must come with its row_ptr.
    for fn in (spmm_cuda.segment_max_sorted, spmm_cuda.segment_max_wide_sorted,
               spmm_cuda._segment_max_sorted_split, spmm_cuda._SegmentMaxWide):
        src = inspect.getsource(fn)
        assert "_plain" not in src
    for fn in (spmm_cuda.segment_max_sorted, spmm_cuda.segment_max_wide_sorted,
               spmm_cuda._segment_max_sorted_split):
        assert "_row_ptr_or_raise(" in inspect.getsource(fn)
    from keras_geometric_tpu_torch.nn import gin_conv, sage_conv
    for module in (gin_conv, sage_conv):
        assert "scatter_max(" in inspect.getsource(module)


def test_wrappers_branch_on_the_tensor_device_only():
    """No try/except around a launch, and the plain version is reached only
    through an ``is_cuda`` test of the data tensor."""
    src = inspect.getsource(spmm_cuda)
    assert "except" not in src
    for fn in (spmm_cuda._scatter_raw, spmm_cuda.gather_scatter_sum_sorted,
               spmm_cuda._expand_raw):
        body = inspect.getsource(fn)
        assert re.search(r"if not \w+\.is_cuda:\n\s+return \w+_plain\(", body)
        assert body.count("_plain(") == 1
    assert "torch.cuda.is_available" not in src
    build_src = inspect.getsource(_build)
    assert "sm_90a" in build_src and "except" not in build_src


def test_attend_wrappers_branch_on_the_tensor_device_only():
    src = inspect.getsource(attend_cuda)
    assert "except" not in src and "torch.cuda.is_available" not in src
    for fn in (attend_cuda.sddmm_stats_agg_sorted,
               attend_cuda.attend_aggregate_sorted,
               attend_cuda.attend_rho_sorted,
               attend_cuda.attend_recv_bwd_full_sorted,
               attend_cuda.attend_send_bwd_sorted):
        body = inspect.getsource(fn)
        assert re.search(r"if not ht\.is_cuda:\n\s+return \w+_plain\(", body)
        assert body.count("_plain(") == 1
        assert f'LAUNCH_COUNTS["{fn.__name__}"] += 1' in body
    # GraphContext.attend reaches the kernels through the wrappers only.
    from keras_geometric_tpu_torch.ops import csr
    assert "_plain" not in inspect.getsource(csr)


def test_attend_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    attend_cuda.reset_launch_counts()
    recv = torch.tensor([0, 0, 2, 3, 3, 3], dtype=torch.int32)
    send = torch.tensor([1, 2, 0, 3, 1, 0], dtype=torch.int32)
    row_ptr = spmm_cuda.row_ptr_from_sorted(recv, 4)
    valid = torch.tensor([True] * 5 + [False])
    gen = torch.Generator().manual_seed(0)
    ht = torch.randn(4, 6, generator=gen)
    att = torch.randn(2, 3, generator=gen)
    g = torch.randn(4, 6, generator=gen)
    graph = (send, recv, row_ptr)
    got = attend_cuda.sddmm_stats_agg_sorted(ht, *graph, att, edge_valid=valid)
    ref = attend_cuda.sddmm_stats_agg_sorted_plain(ht, *graph, att,
                                                   edge_valid=valid)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    out, scores, m, l = got
    assert not out[1].any() and m[1].eq(0).all() and l[1].eq(0).all()
    assert torch.isinf(scores[5]).all() and torch.isfinite(scores[:5]).all()
    rho = attend_cuda.attend_rho_sorted(g, scores, m, l, ht, *graph)
    assert torch.equal(rho, attend_cuda.attend_rho_sorted_plain(
        g, scores, m, l, ht, *graph))
    got = attend_cuda.attend_recv_bwd_full_sorted(
        ht, g, *graph, att, scores, m, l, rho)
    ref = attend_cuda.attend_recv_bwd_full_sorted_plain(
        ht, g, *graph, att, scores, m, l, rho)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not got[2][5].any()  # the invalid slot sends nothing back
    # The other modes, the aggregation from cached scores and the sender
    # backward: their plain versions too, and no launch.
    out3, m3, l3 = attend_cuda.sddmm_stats_agg_sorted(
        ht, *graph, att, edge_valid=valid, emit_scores=False)
    assert torch.equal(out3, out) and torch.equal(m3, m) and torch.equal(l3, l)
    rho_re = attend_cuda.attend_rho_sorted(g, None, m, l, ht, *graph, att=att,
                                           edge_valid=valid)
    assert torch.equal(rho_re, attend_cuda.attend_rho_sorted_plain(
        g, None, m, l, ht, *graph, att=att, edge_valid=valid))
    got2 = attend_cuda.attend_recv_bwd_full_sorted(
        ht, g, *graph, att, None, m, l, rho, emit_v=False, edge_valid=valid)
    assert len(got2) == 2
    agg = attend_cuda.attend_aggregate_sorted(scores, m, l, ht, *graph)
    assert torch.equal(agg, attend_cuda.attend_aggregate_sorted_plain(
        scores, m, l, ht, *graph))
    perm = torch.argsort(send, stable=True)
    s_ss, r_ss = send[perm], recv[perm]
    ptr_ss = spmm_cuda.row_ptr_from_sorted(s_ss, 4)
    valid_ss = valid[perm].float()
    send_args = (ht, g, r_ss, s_ss, ptr_ss, att, m, l, rho)
    assert torch.equal(
        attend_cuda.attend_send_bwd_sorted(*send_args, valid_ss=valid_ss),
        attend_cuda.attend_send_bwd_sorted_plain(*send_args,
                                                 valid_ss=valid_ss))
    assert attend_cuda.LAUNCH_COUNTS == {
        "sddmm_stats_agg_sorted": 0, "attend_aggregate_sorted": 0,
        "attend_rho_sorted": 0, "attend_recv_bwd_full_sorted": 0,
        "attend_send_bwd_sorted": 0}
    assert not any(attend_cuda.MODE_LAUNCH_COUNTS.values())
    assert _build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("module,fns,data", [
    (softmax_cuda, ("softmax_stats_sorted", "softmax_apply_sorted"),
     "scores"),
    (sddmm_cuda, ("sddmm_scores_sorted", "sddmm_bwd_sorted",
                  "sddmm_stats_sorted"), "ht"),
], ids=["softmax", "sddmm"])
def test_composed_wrappers_branch_on_the_tensor_device_only(module, fns,
                                                             data):
    src = inspect.getsource(module)
    assert "except" not in src and "torch.cuda.is_available" not in src
    for name in fns:
        body = inspect.getsource(getattr(module, name))
        assert re.search(
            rf"if not {data}\.is_cuda:\n\s+return \w+_plain\(", body)
        assert body.count("_plain(") == 1
        assert f'LAUNCH_COUNTS["{name}"] += 1' in body


def test_composed_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    softmax_cuda.reset_launch_counts()
    sddmm_cuda.reset_launch_counts()
    recv = torch.tensor([0, 0, 2, 3, 3, 3], dtype=torch.int32)
    row_ptr = spmm_cuda.row_ptr_from_sorted(recv, 4)
    gen = torch.Generator().manual_seed(0)
    scores = torch.randn(6, 2, generator=gen)
    scores[5] = float("-inf")  # a padded slot
    m, l = softmax_cuda.softmax_stats_sorted(scores, recv, row_ptr, 4)
    ref = softmax_cuda.softmax_stats_sorted_plain(scores, recv, 4)
    assert torch.equal(m, ref[0]) and torch.equal(l, ref[1])
    assert not m[1].any() and not l[1].any()  # the empty row
    alpha = softmax_cuda.softmax_apply_sorted(scores, m, l, recv)
    assert torch.equal(alpha, softmax_cuda.softmax_apply_sorted_plain(
        scores, m, l, recv))
    assert not alpha[5].any()
    ht, hj = torch.randn(4, 6, generator=gen), torch.randn(6, 6, generator=gen)
    att, ds = torch.randn(2, 3, generator=gen), torch.randn(6, 2, generator=gen)
    assert torch.equal(
        sddmm_cuda.sddmm_scores_sorted(ht, hj, att, recv),
        sddmm_cuda.sddmm_scores_sorted_plain(ht, hj, att, recv))
    got = sddmm_cuda.sddmm_bwd_sorted(ht, hj, att, ds, recv, row_ptr=row_ptr)
    want = sddmm_cuda.sddmm_bwd_sorted_plain(ht, hj, att, ds, recv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    send = torch.tensor([1, 2, 0, 3, 1, 0], dtype=torch.int32)
    valid = torch.tensor([True] * 5 + [False])
    got = sddmm_cuda.sddmm_stats_sorted(ht, send, recv, row_ptr, att,
                                        edge_valid=valid)
    want = sddmm_cuda.sddmm_stats_sorted_plain(ht, send, recv, row_ptr, att,
                                               edge_valid=valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(softmax_cuda.LAUNCH_COUNTS.values())
    assert not any(sddmm_cuda.LAUNCH_COUNTS.values())
    assert _build.load_library.cache_info().currsize == 0


def test_band_wrappers_branch_on_the_tensor_device_only():
    src = inspect.getsource(band_cuda)
    assert "except" not in src and "torch.cuda.is_available" not in src
    # band_matmul launches through _band_matmul_on (the route it picks),
    # which counts where it launches.
    for fn, launcher, data, counter in (
            (band_cuda.band_matmul, band_cuda._band_matmul_on, "x",
             "band_spmm"),
            (band_cuda.window_scatter_sum, band_cuda.window_scatter_sum,
             "messages", "window_scatter_sum")):
        body = inspect.getsource(fn)
        assert re.search(
            rf"if not {data}\.is_cuda:\n\s+return \w+_plain\(", body)
        assert body.count("_plain(") == 1
        launch = inspect.getsource(launcher)
        assert launcher is fn or f"{launcher.__name__}(" in body
        assert "_plain(" not in launch or launcher is fn
        assert f'LAUNCH_COUNTS["{counter}"] += 1' in launch
    # The autograd wrapper reaches the kernel through the wrapper only.
    assert "_plain" not in inspect.getsource(band_cuda._BandSpmm)


def test_band_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    band_cuda.reset_launch_counts()
    s = np.array([0, 1, 2, 3, 300, 301])
    r = np.array([1, 0, 3, 2, 301, 300])
    plan, local = band_cuda.build_band_plan(s, r, None, 512, window=256)
    assert local.all()
    x = torch.arange(1024, dtype=torch.float32).reshape(512, 2)
    y = band_cuda.band_spmm(x, plan)
    assert torch.equal(y, band_cuda.band_matmul_plain(
        x, plan.band, plan.base_idx, 256, 256))
    np.testing.assert_allclose(y[:4].numpy(), [[2, 3], [0, 1], [6, 7],
                                               [4, 5]])
    senders = np.array([1, 1, 300, 5, 0, 0, 0, 0])
    wplan, _, tab = band_cuda.build_window_scatter_plan(
        senders, 512, np.arange(8) < 4, window=256, edge_chunk=4)
    v = torch.ones(8, 3)
    out = band_cuda.window_scatter_sum(v, torch.from_numpy(tab), wplan)
    assert torch.equal(out, band_cuda.window_scatter_sum_plain(
        v, torch.from_numpy(tab), wplan))
    assert out[1].tolist() == [2, 2, 2] and out.sum().item() == 9
    assert band_cuda.LAUNCH_COUNTS == {"band_spmm": 0,
                                       "window_scatter_sum": 0}
    assert _build.load_library.cache_info().currsize == 0


def test_row_ptr_is_required_for_a_cuda_tensor():
    """The host derivation of ``row_ptr`` serves CPU tensors only: a tensor on
    the card must come with the ``row_ptr`` of graph preparation."""
    recv = torch.tensor([0, 0, 2], dtype=torch.int32)
    on_card = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="row_ptr is required"):
        spmm_cuda._row_ptr_or_raise(on_card, recv, 3, None)
    given = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    assert spmm_cuda._row_ptr_or_raise(on_card, recv, 3, given) is given
    derived = spmm_cuda._row_ptr_or_raise(torch.ones(3, 2), recv, 3, None)
    assert torch.equal(derived, given)


def test_kernels_build_inside_the_checkout():
    assert _build.build_dir() == ROOT / "build" / "kernels"
    assert "environ.get(\"KGT" not in inspect.getsource(_build)
    assert _build.CSRC == PORT / "kernels" / "csrc"
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "attend.cu", "band.cu", "sddmm.cu", "segment_max.cu", "softmax.cu",
        "spmm.cu"]
    assert '_build.load_library("segment_max")' in inspect.getsource(
        spmm_cuda)
    assert '_build.load_library("attend")' in inspect.getsource(attend_cuda)
    assert '_build.load_library("band")' in inspect.getsource(band_cuda)
    assert '_build.load_library("softmax")' in inspect.getsource(softmax_cuda)
    assert '_build.load_library("sddmm")' in inspect.getsource(sddmm_cuda)
    for source in _build.CSRC.iterdir():
        assert "<torch/" not in source.read_text(), source.name
    # The shared header is part of every library's build key.
    assert 'CSRC.glob("*.cuh")' in inspect.getsource(_build.load_library)
    for name in ("attend.cu", "sddmm.cu", "softmax.cu", "segment_max.cu"):
        assert '#include "lanes.cuh"' in (_build.CSRC / name).read_text()


def test_scatter_sum_dispatcher_on_cpu_is_the_segment_sum():
    recv = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    msgs = torch.ones(4, 3)
    out = spmm_ops.scatter_sum(msgs, recv, 3)
    np.testing.assert_allclose(out.numpy(), [[1] * 3, [1] * 3, [2] * 3])
    mask = torch.tensor([True, True, False, True])
    out = spmm_ops.scatter_sum(msgs, recv, 3, mask=mask)
    np.testing.assert_allclose(out.numpy(), [[1] * 3] * 3)


@pytest.mark.parametrize(
    "fn", [kgt_torch.prepare_graph, kgt_torch.GCNConv.__init__,
           kgt_torch.GNNEncoder.__init__, kgt_torch.Dense.__init__,
           kgt_torch.MLP.__init__, kgt_torch.GATv2Conv.__init__,
           kgt_torch.GINConv.__init__, kgt_torch.SAGEConv.__init__,
           kgt_torch.PoolingAggregator.__init__,
           kgt_torch.Graph.from_edge_index, kgt_torch.GraphData.to_graph,
           kgt_torch.utils.batch_graphs_padded,
           kgt_torch.models.GraphClassifier.__init__,
           kgt_torch.AttentionPooling.__init__, kgt_torch.Set2Set.__init__,
           kgt_torch.Module.from_config],
    ids=["prepare_graph", "GCNConv", "GNNEncoder", "Dense", "MLP",
         "GATv2Conv", "GINConv", "SAGEConv", "PoolingAggregator",
         "Graph.from_edge_index", "GraphData.to_graph",
         "batch_graphs_padded", "GraphClassifier", "AttentionPooling",
         "Set2Set", "Module.from_config"])
def test_entry_points_default_to_the_cuda_device(fn):
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"


def test_prepare_graph_without_a_card_raises_instead_of_moving_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        kgt_torch.prepare_graph(np.array([[0, 1], [1, 0]]), 2)


def test_timed_steps_refuses_to_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.timed_steps(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.timed_steps(lambda: None, k_lo=2, k_hi=10, trials=1)


def test_timed_steps_takes_the_references_keywords_and_returns_seconds(
        monkeypatch):
    """The reference's signature (``k_lo=2, k_hi=22, trials=3``) and unit
    (seconds per call), shown with stand-in events on a clock that advances
    5 ms a call: the difference of the two runs, over their lengths."""
    params = inspect.signature(profiling.timed_steps).parameters
    assert {k: params[k].default for k in ("k_lo", "k_hi", "trials")} == {
        "k_lo": 2, "k_hi": 22, "trials": 3}
    calls = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.at = 5.0 * len(calls) + 0.25  # ms; 0.25 ms per record

        def elapsed_time(self, other):
            return other.at - self.at + 0.25

    cuda = types.SimpleNamespace(is_available=lambda: True, Event=Event,
                                 synchronize=lambda: None)
    monkeypatch.setattr(profiling.torch, "cuda", cuda)
    got = profiling.timed_steps(lambda: calls.append(1), k_lo=2, k_hi=10,
                                trials=2)
    assert got == pytest.approx(0.005, rel=1e-12)
    assert len(calls) == 1 + 2 * (2 + 10)
    with pytest.raises(ValueError):
        profiling.timed_steps(lambda: None, k_lo=4, k_hi=4)


def test_timed_steps_measures_again_then_raises_on_no_difference(
        monkeypatch):
    """A difference that noise leaves not positive is measured again over
    longer runs (``k_lo`` doubled, ``k_hi`` quadrupled, the reference's
    rule), at most three times; then it raises instead of returning another
    quantity. Stand-in events: every run of the first measurement reads 1 ms
    whatever its length, later ones 5 ms a call."""
    calls, readings = [], []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.at = 5.0 * len(calls)

        def elapsed_time(self, other):
            readings.append(1)
            return 1.0 if len(readings) <= 4 else other.at - self.at

    cuda = types.SimpleNamespace(is_available=lambda: True, Event=Event,
                                 synchronize=lambda: None)
    monkeypatch.setattr(profiling.torch, "cuda", cuda)
    got = profiling.timed_steps(lambda: calls.append(1), k_lo=2, k_hi=10,
                                trials=2)
    assert got == pytest.approx(0.005, rel=1e-12)
    assert len(calls) == 1 + 2 * (2 + 10) + 2 * (4 + 40)

    class FlatEvent(Event):
        def elapsed_time(self, other):
            return 1.0

    cuda.Event = FlatEvent
    calls.clear()
    with pytest.raises(RuntimeError, match="too short"):
        profiling.timed_steps(lambda: calls.append(1), k_lo=1, k_hi=2,
                              trials=1)
    assert len(calls) == 1 + (1 + 2) + (2 + 8) + (4 + 32) + (8 + 128)


def test_trace_writes_a_trace_into_its_directory(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as where:
        torch.ones(8).add_(1)
    assert where == str(log_dir)
    assert (log_dir / "trace.json").stat().st_size > 0


def test_trace_defaults_to_the_references_directory(monkeypatch):
    """P5: ``with trace():`` takes the reference's default directory and
    would write ``trace.json`` there. The directory and the export are
    stubbed, so that nothing is written outside the test's own files
    (``test_trace_writes_a_trace_into_its_directory`` writes a real one)."""
    ref = importlib.import_module("keras_geometric_tpu.utils.profiling")
    default = inspect.signature(profiling.trace).parameters["log_dir"].default
    assert default == inspect.signature(ref.trace).parameters[
        "log_dir"].default == "/tmp/kgt_trace"
    made, written = [], []
    monkeypatch.setattr(profiling, "os", types.SimpleNamespace(
        makedirs=lambda path, exist_ok: made.append(path), path=os.path))
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: written.append(path))
    with profiling.trace() as where:
        torch.ones(8).add_(1)
    assert where == default and made == [default]
    assert written == [os.path.join(default, "trace.json")]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_partial_run_is_no_pass():
    """A run of a subset of the phases ends with a non-zero exit code and
    prints no ``"ok"`` key: only the full run's last line carries one."""
    module = _chip_smoke_module()
    assert module.PARTIAL_EXIT_CODE not in (0, 1, 2, 3)
    text = (ROOT / "chip_smoke.py").read_text()
    assert text.count('{"ok"') == 2  # the docstring and the last line
    assert text.count('{"ok": True') == 1 and '"ok": False' not in text
    partial = text[text.index("if set(phases) != set(PHASES):"):]
    partial = partial[:partial.index("return PARTIAL_EXIT_CODE")]
    assert "print(json.dumps(" in partial and '{"ok"' not in partial


def test_chip_smoke_names_every_kernel_and_the_line_it_replaces():
    module = _chip_smoke_module()
    kernels = {**spmm_cuda.LAUNCH_COUNTS, **attend_cuda.LAUNCH_COUNTS,
               **softmax_cuda.LAUNCH_COUNTS, **sddmm_cuda.LAUNCH_COUNTS,
               **band_cuda.LAUNCH_COUNTS}
    assert set(module.REPLACES) == set(kernels) and len(kernels) == 18
    assert set(module.launch_counts()) == set(kernels)
    replaces = module.replaced_tpu_kernels()  # checks each pallas_call line
    assert replaces["attend_recv_bwd_full_sorted"].endswith(
        "kernels/attend_pallas.py:737")
    for name, (lib, _, _) in module.REPLACES.items():
        assert (ROOT / module.SOURCES[lib]).is_file(), name
    assert {"train_gat_arxiv_shape", "train_gat_citeseer_shape",
            "train_gat_arxiv_shape_composed",
            "train_gat_citeseer_shape_composed"} <= set(module.PHASES)
    assert replaces["sddmm_bwd_sorted"].endswith("kernels/sddmm_pallas.py:847")
    assert replaces["band_spmm"].endswith("kernels/band_pallas.py:393")
    assert replaces["window_scatter_sum"].endswith(
        "kernels/band_pallas.py:249")
    assert {"train_skewed_arxiv_shape",
            "train_gat_skewed_arxiv_shape"} <= set(module.PHASES)
    assert replaces["sddmm_stats_sorted"].endswith(
        "kernels/sddmm_pallas.py:316")
    assert replaces["attend_aggregate_sorted"].endswith(
        "kernels/attend_pallas.py:205")
    assert replaces["attend_send_bwd_sorted"].endswith(
        "kernels/attend_pallas.py:958")
    assert {"train_gat_arxiv_shape_send", "train_gat_arxiv_shape_nocache",
            "train_gat_arxiv_shape_send_nocache",
            "train_gat_citeseer_shape_send",
            "attend_two_pass_arxiv_shape"} <= set(module.PHASES)
    assert replaces["segment_max_sorted"].endswith(
        "kernels/spmm_pallas.py:915")
    assert replaces["segment_max_wide_sorted"].endswith(
        "kernels/spmm_pallas.py:1071")
    assert replaces["segment_max_wide_bwd"].endswith(
        "kernels/spmm_pallas.py:1071")
    assert module.SOURCES["segment_max"].endswith("csrc/segment_max.cu")
    assert {"segment_max_narrow_arxiv_shape", "train_sage_pool_arxiv_shape",
            "train_gin_max_arxiv_shape",
            "train_sage_cora_shape"} <= set(module.PHASES)
    # ogbn-products on one card, right after the arxiv GCN.
    at = module.PHASES.index("train_gcn_ogbn_arxiv")
    assert module.PHASES[at:at + 3] == (
        "train_gcn_ogbn_arxiv", "train_gcn_ogbn_products",
        "train_gat_ogbn_products")
    # The hardware accuracy gate runs last, every run of the tool at 60
    # steps (the reference gate's default).
    assert module.PHASES[-1] == "accuracy_trajectory"
    tool = module.accuracy_tool()
    assert list(tool.RUNS) == ["gcn_f32", "gcn_bf16",
                               "gat_send_products_widths"]
    assert module.ACCURACY_STEPS == 60


def test_roofline_uses_the_cards_constants():
    assert profiling.H100_BYTES_PER_S == 3.35e12
    r = profiling.Roofline().add_spmm(1_000_000, 128, 100_000)
    rep = r.report(1e-3)
    assert rep["bound_by"] == "bytes"
    expect = (2 * 2 * 100_000 * 128 + 8 * 1_000_000 + 4 * 100_001) / 3.35e12
    np.testing.assert_allclose(rep["bound_s"], expect, rtol=1e-12)
    rep = profiling.Roofline().add_matmul(4096, 4096, 4096).report(
        1e-3, tensor_cores=True)
    assert rep["bound_by"] == "operations"


def test_roofline_reports_the_references_keys_beside_the_ports():
    assert profiling.CHIP_SPECS["h100"] == (989.0, 67.0, 3350.0)
    utils = importlib.import_module("keras_geometric_tpu_torch.utils")
    for name in ("trace", "timed_steps", "Roofline", "CHIP_SPECS"):
        assert name in profiling.__all__ and name in utils.__all__
        assert getattr(utils, name) is getattr(profiling, name)
    r = profiling.Roofline(chip="h100").add_spmm(1_000_000, 128, 100_000)
    rep = r.report(1e-3)
    assert rep["bound"] == "memory" and rep["bound_by"] == "bytes"
    assert rep["speed_of_light_s"] == rep["bound_s"]
    assert rep["efficiency"] == rep["roofline_share"] == rep["bound_s"] / 1e-3
    np.testing.assert_allclose(rep["hbm_utilization"],
                               r.bytes / 1e-3 / 3.35e12, rtol=1e-12)
    np.testing.assert_allclose(rep["achieved_gbps"], r.bytes / 1e-3 / 1e9,
                               rtol=1e-12)
    mm = profiling.Roofline(chip="h100").add_matmul(4096, 4096, 4096)
    f32, bf16 = mm.report(1e-3), mm.report(1e-3, use_bf16_peak=True)
    assert f32["bound"] == bf16["bound"] == "compute"
    np.testing.assert_allclose(f32["speed_of_light_s"], mm.flops / 67e12,
                               rtol=1e-12)
    np.testing.assert_allclose(bf16["speed_of_light_s"], mm.flops / 989e12,
                               rtol=1e-12)
    assert mm.report(1e-3, tensor_cores=True) == bf16
    np.testing.assert_allclose(bf16["achieved_tflops"], mm.flops / 1e-3 / 1e12,
                               rtol=1e-12)


def test_subgraph_to_arrays_defaults_to_the_card():
    from keras_geometric_tpu_torch.training import sage_minibatch

    assert "device=None" in str(inspect.signature(
        sage_minibatch.subgraph_to_arrays))
    assert 'device = "cuda" if device is None' in inspect.getsource(
        sage_minibatch.subgraph_to_arrays)


def test_native_fallbacks_are_bit_identical():
    rng = np.random.default_rng(0)
    n = 50
    s = rng.integers(0, n, 400).astype(np.int32)
    r = rng.integers(0, n, 400).astype(np.int32)
    got = (native.coo_to_csr_perm(r, n), native.gcn_norm_weights(s, r, n),
           native.in_degree(r, n))
    native._lib.cache_clear()
    path, native._LIB_PATH = native._LIB_PATH, "/nonexistent/libgraph_core.so"
    try:
        assert not native.available()
        ref = (native.coo_to_csr_perm(r, n), native.gcn_norm_weights(s, r, n),
               native.in_degree(r, n))
    finally:
        native._LIB_PATH = path
        native._lib.cache_clear()
    np.testing.assert_array_equal(got[0][0], ref[0][0])
    np.testing.assert_array_equal(got[0][1], ref[0][1])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


def test_graph_ops_host_helpers_match_reference():
    from keras_geometric_tpu.ops import graph_ops as jgo
    from keras_geometric_tpu_torch.ops import graph_ops as tgo

    rng = np.random.default_rng(1)
    s = rng.integers(0, 9, 30).astype(np.int32)
    r = rng.integers(0, 9, 30).astype(np.int32)
    a, b = jgo.coo_to_csr(s, r, 9, pad_to=40), tgo.coo_to_csr(s, r, 9, pad_to=40)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert tgo.round_up(13, 8) == jgo.round_up(13, 8) == 16
    with pytest.raises(ValueError, match="pad_to"):
        tgo.coo_to_csr(s, r, 9, pad_to=3)
    with pytest.raises(ValueError, match="rank-2"):
        tgo.ensure_edge_index(np.zeros(3))
    with pytest.raises(ValueError, match=r"\[2, E\]"):
        tgo.ensure_edge_index(np.zeros((3, 3)))


@pytest.mark.parametrize("indices_are_sorted", [False, True])
def test_gcn_norm_takes_indices_are_sorted_as_the_reference_does(
        indices_are_sorted):
    """P4: ``gcn_norm(..., indices_are_sorted=)`` as the reference's, with
    and without a mask, on receivers in order (so both values are true)."""
    from keras_geometric_tpu.ops import graph_ops as jgo
    from keras_geometric_tpu_torch.ops import graph_ops as tgo

    ei = np.array([[0, 2, 1, 0], [0, 1, 2, 2]], np.int32)
    want = np.asarray(jgo.gcn_norm(ei, 3,
                                   indices_are_sorted=indices_are_sorted))
    got = tgo.gcn_norm(torch.from_numpy(ei), 3,
                       indices_are_sorted=indices_are_sorted)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), [1.0] + [0.7071068] * 3,
                               rtol=1e-6)
    mask = np.array([True, True, False, True])
    want = np.asarray(jgo.gcn_norm(ei, 3, edge_mask=mask,
                                   indices_are_sorted=indices_are_sorted))
    got = tgo.gcn_norm(torch.from_numpy(ei), 3,
                       edge_mask=torch.from_numpy(mask),
                       indices_are_sorted=indices_are_sorted)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _flags(path):
    return dict(re.findall(r'add_argument\("(--[\w-]+)"(.*)\)\s*$',
                           path.read_text(), re.M))


def test_every_example_has_a_twin_with_its_flags_and_chip_smoke_runs_it():
    examples = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    twins = sorted(p.name for p in (ROOT / "examples_torch").glob("*.py"))
    assert twins == examples and len(twins) == 10
    for name in twins:
        ref, twin = (_flags(ROOT / "examples" / name),
                     _flags(ROOT / "examples_torch" / name))
        assert twin == {**ref, "--device": ', default="cuda"'}, name
        text = (ROOT / "examples_torch" / name).read_text()
        assert "device = pick_device(args.device)" in text, name
        # the port's one device rule, imported, not a copy of it
        assert re.search(r"^from keras_geometric_tpu_torch\.utils import "
                         r"(.*, )?pick_device\b", text, re.M), name
        assert "def pick_device" not in text, name
    module = _chip_smoke_module()
    assert {script for script, _ in module.EXAMPLE_RUNS} == set(twins)
    assert ("node_classification.py",
            ("--epochs", "1", "--dataset", "pubmed")) in module.EXAMPLE_RUNS
    for script, args in module.EXAMPLE_RUNS:  # the fewest epochs allowed
        assert ("--epochs" in _flags(ROOT / "examples_torch" / script)) == (
            args[:2] == ("--epochs", "1")), script
    assert module.PHASES[-4:] == ("train_gin_graph_classification",
                                  "readouts_on_card", "examples_torch",
                                  "accuracy_trajectory")
    assert module.PHASES.index("train_gat_ogbn_products") < \
        module.PHASES.index("train_distributed_arxiv_shape")


@pytest.mark.parametrize("script", ["simple_gcn.py", "pooling_readouts.py"])
def test_a_twin_without_a_card_raises_instead_of_moving_to_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, f"examples_torch/{script}"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and not proc.stdout


def test_pick_device_names_the_device_and_never_moves_to_the_cpu():
    from keras_geometric_tpu_torch.utils import pick_device

    assert pick_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pick_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pick_device()
