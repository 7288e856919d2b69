"""Weight bridge: the JAX package's flax variables -> the port's state dict.

The port's modules carry the reference's torch state-dict names, which is
the layout superpoint_graph_tpu/learn/convert_torch.py::convert_state_dict
maps onto the flax tree (torch -> flax; jax-free). This module inverts that
map rather than restating it: every entry of the port's state dict is
replaced by the positions of its elements, the positions are pushed through
`convert_state_dict`, and each flax leaf then says where its values go.
The inverse is therefore exact by construction, and every element of the
state dict must be reached exactly once, with the flax leaf of the same
shape, or the bridge raises.
"""
from __future__ import annotations

import numpy as np
import torch

from superpoint_graph_tpu.learn.convert_torch import convert_state_dict


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def flax_to_state_dict(variables: dict, model) -> dict:
    """{"params", "batch_stats"} flax tree (numpy or jax arrays) -> a state
    dict for `model` (the port's SpgModel), float32 CPU tensors."""
    sd = model.state_dict()
    sizes = [v.numel() for v in sd.values()]
    total = sum(sizes)
    if total >= 2**24:  # positions must stay exact in float32
        raise ValueError(f"{total} parameters: too many for the position map")
    offsets = np.cumsum([0] + sizes)
    probe = {
        k: np.arange(o, o + v.numel(), dtype=np.float64).reshape(v.shape)
        for (k, v), o in zip(sd.items(), offsets)
    }
    flat = np.full(total, np.nan, np.float32)
    hits = np.zeros(total, np.int64)
    for coll, tree in convert_state_dict(probe, model).items():
        for path, pos in _leaves(tree):
            value = np.asarray(_get(variables[coll], path), np.float32)
            if value.shape != pos.shape:
                raise ValueError(f"{coll}/{'/'.join(path)}: flax shape "
                                 f"{value.shape}, port expects {pos.shape}")
            idx = pos.astype(np.int64).ravel()
            flat[idx] = value.ravel()
            hits[idx] += 1
    if not (hits == 1).all():
        missed = [k for k, o, n in zip(sd, offsets, sizes)
                  if not (hits[o:o + n] == 1).all()]
        raise ValueError(f"state-dict entries not mapped exactly once: {missed}")
    return {k: torch.from_numpy(flat[o:o + v.numel()].reshape(v.shape).copy())
            for (k, v), o in zip(sd.items(), offsets)}
