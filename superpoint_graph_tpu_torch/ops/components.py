"""Connected components over active-edge subgraphs, with small-component
fusing, on the host.

Carried over unchanged in behaviour from the host half of
superpoint_graph_tpu/ops/components.py (`group_components`,
`connected_components`, `_fuse_small`, `relabel_connected`), whose module
imports jax. Reference: `libply_c.connected_comp`
(connected_components.cpp:17-110).

`relabel_connected` runs the host library's union-find
(`native.connected_comp`), as the JAX version does whenever its library
builds; `connected_components` is the JAX package's numpy/scipy op, which
both packages call elsewhere (the exact solver, the band solver's cutoff,
SSP). The two agree at cutoff 0; above it the library fuses in rounds that
renumber the components between them, `_fuse_small` without renumbering, so
ties between equal-sized neighbours can part (ROADMAP queue 3).
`relabel_connected_plain` is the scipy path, for the tests.
"""
from __future__ import annotations

import numpy as np

from .. import native


def _cc_labels(n_ver: int, src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Component labels via scipy's C connected-components."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as scipy_cc

    if len(src) == 0:
        return np.arange(n_ver, dtype=np.int64)
    adj = sp.csr_matrix(
        (np.ones(len(src), np.int8), (src, tgt)), shape=(n_ver, n_ver)
    )
    _, labels = scipy_cc(adj, directed=False)
    return labels.astype(np.int64)


def group_components(in_comp: np.ndarray, n_comp: int | None = None):
    """Vertex ids split by component label: one uint32 array per dense label,
    from a single stable argsort."""
    in_comp = np.asarray(in_comp)
    if n_comp is None:
        n_comp = int(in_comp.max()) + 1 if in_comp.size else 0
    order = np.argsort(in_comp, kind="stable").astype(np.uint32)
    counts = np.bincount(in_comp, minlength=n_comp)
    return np.split(order, np.cumsum(counts)[:-1])


def _first_occurrence_ids(labels: np.ndarray) -> np.ndarray:
    _, first_pos, inv = np.unique(labels, return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first_pos))[inv]


def connected_components(n_ver: int, source: np.ndarray, target: np.ndarray,
                         active_edge: np.ndarray, cutoff: int):
    """Components of the active subgraph, then components smaller than
    `cutoff` fused into their largest neighbour. Returns (components,
    in_component int32 [n]) with ids in first-vertex order."""
    source = np.asarray(source, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    active = np.asarray(active_edge).astype(bool)

    in_comp = _first_occurrence_ids(
        _cc_labels(n_ver, source[active], target[active])
    )
    n_comp = in_comp.max() + 1 if n_ver else 0
    if cutoff > 0 and n_comp > 1:
        in_comp = _first_occurrence_ids(
            _fuse_small(in_comp, source, target, ~active, cutoff)
        )
        n_comp = in_comp.max() + 1
    return group_components(in_comp, n_comp), in_comp.astype(np.int32)


def relabel_connected(n_ver: int, source: np.ndarray, target: np.ndarray,
                      in_component: np.ndarray, cutoff: int = 0):
    """Every label split into the connected pieces it has in the graph,
    then pieces smaller than `cutoff` fused, by the host library's
    union-find over the edges whose ends share a label. The chunked
    giant-cloud solver needs it: a window's label kept on the window's core
    can be connected only through halo vertices outside the core. Returns
    (components, in_component int32) in first-occurrence order."""
    source = np.asarray(source)
    target = np.asarray(target)
    in_component = np.asarray(in_component)
    active = in_component[source] == in_component[target]
    return native.connected_comp(n_ver, source, target, active, cutoff)


def relabel_connected_plain(n_ver: int, source: np.ndarray,
                            target: np.ndarray, in_component: np.ndarray,
                            cutoff: int = 0):
    """`relabel_connected` by scipy (`connected_components`): equal to it
    at cutoff 0; for the tests."""
    source = np.asarray(source)
    target = np.asarray(target)
    in_component = np.asarray(in_component)
    active = in_component[source] == in_component[target]
    return connected_components(n_ver, source, target, active, cutoff)


def _fuse_small(in_comp, source, target, inactive_mask, cutoff):
    """Absorb components of size < cutoff into their largest neighbour seen
    through inactive edges, all undersized components per round (cycles
    broken toward the larger, then lower-id, component)."""
    in_comp = in_comp.copy()
    src_i = source[inactive_mask]
    tgt_i = target[inactive_mask]
    for _ in range(64):
        sizes = np.bincount(in_comp)
        n_comp = len(sizes)
        small = sizes < cutoff
        if not small.any():
            break
        a = np.concatenate([in_comp[src_i], in_comp[tgt_i]])
        b = np.concatenate([in_comp[tgt_i], in_comp[src_i]])
        sel = (a != b) & small[a]
        a, b = a[sel], b[sel]
        if len(a) == 0:
            break
        # best neighbour per small comp = max by (size, -id)
        enc = sizes[b].astype(np.int64) * (n_comp + 1) + (n_comp - b)
        best = np.full(n_comp, -1, np.int64)
        np.maximum.at(best, a, enc)
        tgt_comp = n_comp - (best % (n_comp + 1))
        ids = np.arange(n_comp)
        move = (best >= 0) & small & (
            (sizes[tgt_comp] > sizes)
            | ((sizes[tgt_comp] == sizes) & (tgt_comp < ids))
        )
        if not move.any():
            break
        mapping = ids.copy()
        mapping[move] = tgt_comp[move]
        in_comp = mapping[in_comp]
    return in_comp
