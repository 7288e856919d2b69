"""The cut-pursuit merge step with its edge-to-region reduction on the device.

Port of superpoint_graph_tpu/ops/merge_device.py (`pair_stats`,
`merge_regions_device`, `_dedup_pairs`, `_compact_cross`, `_compact_pairs`;
the JAX `LAST_MERGE_STATS` seconds are the stages `spgt.cp.merge.reduce`
and `spgt.cp.merge.rounds`). The merge step's only O(edges)
work is turning the edge list into region statistics: per-region weighted
feature sums S and masses m, and the adjacent region pairs with their summed
cut weights. That runs on the device; only the O(regions + pairs) results
come back, and the greedy rounds run on the host
(`ops/cutpursuit.py::merge_rounds`, the same rounds as the host
`merge_regions`).

torch has int64, so a pair is one key lo * cap + hi where JAX sorts two
int32 keys. The cross-region edges are always compacted before the pair
sort: a boolean index has no static capacity to spill, so the JAX
COMPACT_THRESHOLD (below it JAX sorts every edge, to spare the per-chunk
merge a spill and retry) has nothing to choose here. Every float sum runs in a fixed order (a stable sort by segment,
then a 1-D `segment_reduce`, `cutpursuit_band._Segments`), never a float
`index_add_`, so the merge is bit-reproducible on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing
from ..utils.tracing import stage
from .cutpursuit import merge_rounds
from .cutpursuit_band import _Segments


def _compact_cross(comp, src, tgt, w):
    """The cross-region edges (comp[src] != comp[tgt], w > 0) as (ca, cb,
    w). A boolean index compacts on the device (JAX fills a static-capacity
    buffer and retries on spill)."""
    ca, cb = comp[src], comp[tgt]
    keep = (ca != cb) & (w > 0)
    return ca[keep], cb[keep], w[keep]


def _dedup_pairs(ca, cb, w, cap: int):
    """Cross-region pairs (ca, cb) with weights w: the keys lo * cap + hi
    stably sorted with their weights, and the run starts `new`."""
    key_s, order = torch.sort(torch.minimum(ca, cb) * cap
                              + torch.maximum(ca, cb), stable=True)
    new = torch.ones_like(key_s, dtype=torch.bool)
    new[1:] = key_s[1:] != key_s[:-1]
    return key_s, w[order], new


def _compact_pairs(key_s, w_s, new, cap: int):
    """The sorted runs as pair tables (pair_a, pair_b, pair_w), each run's
    weights summed in order."""
    if len(key_s) == 0:
        return key_s, key_s, w_s
    pid = torch.cumsum(new.to(torch.int64), 0) - 1
    n_pairs = int(tracing.to_host(pid[-1], "merge.pairs")) + 1
    pw = _Segments(pid, n_pairs, presorted=True).sum(w_s)
    key = key_s[new]
    return key // cap, key % cap, pw


def pair_stats(f, nw, comp, src, tgt, w, n_comp: int):
    """Region statistics of a partition, reduced on the device, returned as
    numpy: (S [n_comp, d] f64, m [n_comp], pair_a, pair_b [n_pairs] int64
    with pair_a < pair_b, pair_w [n_pairs] f64). `comp` [n] integer labels in
    [0, n_comp); (src, tgt, w) directed edges, each direction of an edge
    adding its weight to the pair."""
    comp = comp.to(torch.int64)
    by_comp = _Segments(comp, n_comp)
    s = by_comp.sum(torch.cat([f * nw[:, None], nw[:, None]], 1))
    cap = max(n_comp, 2)
    key_s, w_s, new = _dedup_pairs(*_compact_cross(comp, src, tgt, w), cap)
    pa, pb, pw = _compact_pairs(key_s, w_s, new, cap)
    s = tracing.to_host(s.double(), "merge.sums").numpy()
    return (s[:, :-1], s[:, -1],
            tracing.to_host(pa, "merge.pairs").numpy(),
            tracing.to_host(pb, "merge.pairs").numpy(),
            tracing.to_host(pw.double(), "merge.pairs").numpy())


def merge_regions_device(f, nw, comp, src, tgt, w, n_comp: int, reg: float,
                         max_rounds: int = 10, times: dict | None = None
                         ) -> np.ndarray:
    """The merge step with the edge reduction on the device: the greedy
    rounds and energy delta of `ops/cutpursuit.py::merge_regions`. Returns
    the root of every region [n_comp] (numpy); the caller applies it to its
    own labels. `times`: the seconds of the device reduction with its
    fetch and of the host rounds are added to its "merge_reduce" and
    "merge_rounds"."""
    with stage("spgt.cp.merge.reduce", times, "merge_reduce"):
        S, m, pa, pb, pw = pair_stats(f, nw, comp, src, tgt, w, n_comp)
    if len(pa) == 0:
        return np.arange(n_comp)
    with stage("spgt.cp.merge.rounds", times, "merge_rounds"):
        return merge_rounds(S, m, pa, pb, pw, n_comp, reg,
                            max_rounds=max_rounds)
