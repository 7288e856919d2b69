"""The model's weights, drawn by the benchmark from the run's seed.

One normal draw on the device (a torch.Generator on the card, in the
float32 the model is served and trained in) is cut into every parameter
and batch-norm statistic of the reference's layout
(reference/model.py::param_specs); the same tensors are loaded into the
program's model and handed to the reference. Matrices get N(0, 1/fan_in);
biases, batch-norm shifts and running means N(0, 0.1^2); batch-norm scales
and running variances 1 + U-shaped small offsets, so that no layer is an
identity the checks could not see through.
"""
from __future__ import annotations

import math

import torch

from ..reference.model import param_specs


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for the model of `cfg` (a
    configuration's "model" entry), from `seed`."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for (name, shape, kind), part in zip(specs, torch.split(flat, sizes)):
        x = part.reshape(shape)
        if kind == "weight":
            x = x / math.sqrt(math.prod(shape[1:]))
        elif kind == "stn_proj":
            x = x * (0.1 / math.sqrt(shape[1]))
        elif kind in ("bias", "bn_bias", "bn_mean"):
            x = x * 0.1
        elif kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn_var":
            x = 1.0 + 0.1 * x.abs()
        out[name] = x.contiguous()
    return out
