"""ctypes binding of the host library (csrc/spgt_native.cpp).

The port's counterpart of superpoint_graph_tpu/native/__init__.py, with its
signatures and return conventions:
  prune            <- libply_c.prune          (ply_c.cpp:497-505)
  compute_geof     <- libply_c.compute_geof
  connected_comp   <- libply_c.connected_comp
  random_subgraph  <- libply_c.random_subgraph
  cutpursuit       <- libcp.cutpursuit
  greedy_matching  <- the merge rounds' conflict scan (ops/cutpursuit.py)

The library is compiled with g++ at first use (ops/_build.py::build_host)
and loaded once; a failed build raises with g++'s output. Nothing here falls
back to Python: the plain versions (`ops/voxel.py::prune_plain`,
`ops/components.py::relabel_connected_plain`,
`ops/cutpursuit.py::greedy_matching_plain`, `ops/geof.py`, the exact solver
`ops/cutpursuit.py::cutpursuit`) are what the tests hold the library to.
Each function counts its calls in `<function>.calls`, so a run can show that
its path went through the library, and is the span `spgt.native.<function>`
when tracing is on (`utils/tracing.py`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .ops import _build
from .utils import tracing

_P = ctypes.POINTER
_u8, _u32, _u64 = ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint64
_i32, _i64, _f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "spgt_prune": (_u64, [_P(_f32), _u64, _f32, _P(_u8), _P(_i32), _P(_i32),
                          _i32, _i32, _P(_f32), _P(_f32), _P(_u32), _P(_u32),
                          _P(_u32), _P(_i32)]),
    "spgt_compute_geof": (None, [_P(_f32), _P(_u32), _u64, _i32, _P(_f32)]),
    "spgt_connected_comp": (_i64, [_i64, _i64, _P(_u32), _P(_u32), _P(_u8),
                                   _i32, _P(_i32)]),
    "spgt_random_subgraph": (None, [_i64, _i64, _P(_u32), _P(_u32), _i64,
                                    _u32, _P(_u8), _P(_u8)]),
    "spgt_cutpursuit": (_i64, [_P(_f32), _i64, _i32, _i64, _P(_u32),
                               _P(_u32), _P(_f32), _P(_f32), _f32, _i32,
                               _i32, _i32, _P(_i32)]),
    "spgt_greedy_matching": (_u64, [_P(_i64), _P(_i64), _u64, _u64,
                                    _P(_u8)]),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("spgt_native")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


def _counted(fn):
    """fn counting its calls in `.calls`, each the span
    `spgt.native.<fn>`."""
    name = "spgt.native." + fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        with tracing.span(name):
            return fn(*args, **kwargs)

    wrapper.calls = 0
    return wrapper


@_counted
def prune(xyz, voxel_size, rgb, labels, objects, n_labels, n_objects):
    """libply_c.prune: (xyz f32, rgb u8, label_hist u32, obj_hist u32) of
    the occupied voxels in first-occurrence order. Voxel keys from f32
    coordinates, sums in f32 in point order."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    rgb = np.ascontiguousarray(
        rgb if rgb is not None else np.zeros((n, 3)), np.uint8)
    labels = np.ascontiguousarray(
        labels if labels is not None and np.size(labels) else np.zeros(n),
        np.int32)
    objects = np.ascontiguousarray(
        objects if objects is not None and np.size(objects) else np.zeros(n),
        np.int32)
    out_xyz = np.zeros((n, 3), np.float32)
    out_rgb = np.zeros((n, 3), np.float32)
    lh = np.zeros((n, n_labels + 1), np.uint32)
    oh = np.zeros((n, n_objects + 1), np.uint32)
    counts = np.zeros(n, np.uint32)
    pv = np.zeros(n, np.int32)
    m = _lib().spgt_prune(
        _ptr(xyz, _f32), n, voxel_size, _ptr(rgb, _u8), _ptr(labels, _i32),
        _ptr(objects, _i32), n_labels, n_objects, _ptr(out_xyz, _f32),
        _ptr(out_rgb, _f32), _ptr(lh, _u32), _ptr(oh, _u32),
        _ptr(counts, _u32), _ptr(pv, _i32))
    return out_xyz[:m], out_rgb[:m].astype(np.uint8), lh[:m], oh[:m]


@_counted
def compute_geof(xyz, neighbors, k_nn):
    """libply_c.compute_geof: [n, 4] f32 linearity, planarity, scattering,
    verticality of each point's neighbourhood (itself and its k_nn
    neighbours), in float64 inside."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    nbrs = np.ascontiguousarray(
        np.asarray(neighbors).reshape(len(xyz), k_nn), np.uint32)
    out = np.zeros((len(xyz), 4), np.float32)
    _lib().spgt_compute_geof(_ptr(xyz, _f32), _ptr(nbrs, _u32), len(xyz),
                             k_nn, _ptr(out, _f32))
    return out


@_counted
def connected_comp(n_ver, source, target, active_edge, cutoff):
    """libply_c.connected_comp: (components, in_component int32) of the
    active subgraph, numbered by first vertex, then rounds in which every
    component smaller than `cutoff` joins its largest neighbour through an
    inactive edge, renumbered after each round."""
    src = np.ascontiguousarray(source, np.uint32)
    tgt = np.ascontiguousarray(target, np.uint32)
    act = np.ascontiguousarray(active_edge, np.uint8)
    out = np.zeros(n_ver, np.int32)
    n_comp = _lib().spgt_connected_comp(
        n_ver, len(src), _ptr(src, _u32), _ptr(tgt, _u32), _ptr(act, _u8),
        cutoff, _ptr(out, _i32))
    from .ops.components import group_components

    return group_components(out, n_comp), out


@_counted
def random_subgraph(n_ver, source, target, subgraph_size, seed=0):
    """libply_c.random_subgraph: (edge mask, vertex mask) of a BFS forest
    of `subgraph_size` vertices grown from mt19937(seed) seeds."""
    src = np.ascontiguousarray(source, np.uint32)
    tgt = np.ascontiguousarray(target, np.uint32)
    edge_sel = np.zeros(len(src), np.uint8)
    ver_sel = np.zeros(n_ver, np.uint8)
    _lib().spgt_random_subgraph(
        n_ver, len(src), _ptr(src, _u32), _ptr(tgt, _u32), subgraph_size,
        seed, _ptr(edge_sel, _u8), _ptr(ver_sel, _u8))
    return edge_sel.astype(bool), ver_sel.astype(bool)


@_counted
def cutpursuit(features, source, target, edge_weight, reg_strength,
               cutoff=0, spatial=False, weight_decay=0.7, node_weight=None,
               max_iter=10, flow_steps=3):
    """libcp.cutpursuit: (components, in_component) of the l0 cut pursuit
    with Dinic max-flow splits; `spatial` and `weight_decay` are not read,
    as in the JAX package's binding."""
    del spatial, weight_decay
    f = np.ascontiguousarray(features, np.float32)
    if f.ndim == 1:
        f = f[:, None]
    n, d = f.shape
    src = np.ascontiguousarray(source, np.uint32)
    tgt = np.ascontiguousarray(target, np.uint32)
    ew = np.ascontiguousarray(edge_weight, np.float32)
    nw = np.ascontiguousarray(
        node_weight if node_weight is not None else np.ones(n), np.float32)
    out = np.zeros(n, np.int32)
    n_comp = _lib().spgt_cutpursuit(
        _ptr(f, _f32), n, d, len(src), _ptr(src, _u32), _ptr(tgt, _u32),
        _ptr(ew, _f32), _ptr(nw, _f32), reg_strength, cutoff, max_iter,
        flow_steps, _ptr(out, _i32))
    from .ops.components import group_components

    return group_components(out, n_comp), out


@_counted
def greedy_matching(a, b, n_comp):
    """Accept mask over ordered merge candidates: candidate i is accepted
    iff neither region a[i] nor b[i] was touched by an earlier accepted
    one."""
    a = np.ascontiguousarray(a, np.int64)
    b = np.ascontiguousarray(b, np.int64)
    accept = np.zeros(len(a), np.uint8)
    _lib().spgt_greedy_matching(_ptr(a, _i64), _ptr(b, _i64), len(a),
                                int(n_comp), _ptr(accept, _u8))
    return accept.astype(bool)
