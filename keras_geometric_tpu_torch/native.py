"""ctypes bindings for the native graph_core library (C++), host side.

The port's own copy of the loader: ``native/libgraph_core.so`` lies outside
both packages and is framework-free. It is loaded when present and loadable;
otherwise the numpy fallbacks run, which return bit-identical results. The
import never fails and nothing is compiled here.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

__all__ = [
    "available",
    "coo_to_csr_perm",
    "gcn_norm_weights",
    "uniform_sample",
    "in_degree",
]

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "native",
    "libgraph_core.so",
)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL | None:
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.kgt_coo_to_csr.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
    ]
    lib.kgt_gcn_norm.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, f32p,
    ]
    lib.kgt_uniform_sample.argtypes = [
        i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        i64p,
    ]
    lib.kgt_in_degree.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    return lib


def available() -> bool:
    """True when the native library is loadable."""
    return _lib() is not None


def coo_to_csr_perm(
    receivers: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stable receiver sort: returns ``(perm [E] int64, row_ptr [N+1] int64)``."""
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = receivers.shape[0]
    lib = _lib()
    if lib is None:
        perm = np.argsort(receivers, kind="stable").astype(np.int64)
        row_ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(
            np.bincount(receivers, minlength=num_nodes), out=row_ptr[1:]
        )
        return perm, row_ptr
    perm = np.empty(e, np.int64)
    row_ptr = np.empty(num_nodes + 1, np.int64)
    lib.kgt_coo_to_csr(receivers, e, num_nodes, perm, row_ptr)
    return perm, row_ptr


def gcn_norm_weights(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Symmetric GCN edge weights ``(d[r]+1e-12)^-1/2 (d[s]+1e-12)^-1/2``."""
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    e = senders.shape[0]
    lib = _lib()
    if lib is None:
        deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
        inv = np.power(deg + 1e-12, -0.5)
        inv[np.isinf(inv)] = 0.0
        return (inv[receivers] * inv[senders]).astype(np.float32)
    out = np.empty(e, np.float32)
    lib.kgt_gcn_norm(senders, receivers, e, num_nodes, out)
    return out


def uniform_sample(
    sorted_senders: np.ndarray,
    row_ptr: np.ndarray,
    seeds: np.ndarray,
    fanout: int,
    seed: int = 0,
) -> np.ndarray:
    """Uniform in-neighbor sampling: ``[len(seeds), fanout]`` int64, -1 pad.

    A node of degree at most ``fanout`` keeps all its in-neighbors in CSR
    order; a larger one draws ``fanout`` of them without replacement. The
    library draws with ``std::mt19937_64`` seeded by ``seed``, the fallback
    with ``np.random.default_rng(seed).choice`` once per such node: the two
    give different (equally uniform) samples.
    """
    sorted_senders = np.ascontiguousarray(sorted_senders, np.int32)
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    b = seeds.shape[0]
    lib = _lib()
    if lib is None:
        rng = np.random.default_rng(seed)
        out = np.full((b, fanout), -1, np.int64)
        for i, v in enumerate(seeds):
            lo, hi = int(row_ptr[v]), int(row_ptr[v + 1])
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= fanout:
                out[i, :deg] = sorted_senders[lo:hi]
            else:
                pick = rng.choice(deg, size=fanout, replace=False)
                out[i] = sorted_senders[lo + pick]
        return out
    out = np.empty(b * fanout, np.int64)
    lib.kgt_uniform_sample(
        sorted_senders, row_ptr, seeds, b, fanout, seed, out
    )
    return out.reshape(b, fanout)


def in_degree(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    receivers = np.ascontiguousarray(receivers, np.int32)
    lib = _lib()
    if lib is None:
        return np.bincount(receivers, minlength=num_nodes).astype(np.int64)
    out = np.empty(num_nodes, np.int64)
    lib.kgt_in_degree(receivers, receivers.shape[0], num_nodes, out)
    return out
