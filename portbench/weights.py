"""Seeded weights, made by the benchmark and handed to both the program and
the reference.

One draw of normals on the device, from a generator seeded by the run's
seed, is cut into the parameters (their names and shapes are the
reference's, which the program's state dict must match exactly): matrices
scaled by 1 / sqrt(fan_in), LayerNorm gains 1 + 0.1 N, biases 0.02 N, the
moment query embedding N(0, 1), and logit_scale = log(1 / temperature).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.made import param_shapes


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        r = flat[at:at + n].reshape(shape)
        at += n
        if name == "logit_scale":
            w = torch.full((), math.log(1.0 / cfg["model.temperature_init_value"]),
                           device=device)
        elif name == "decoder_query_embed.weight":
            w = r.clone()
        elif len(shape) == 2:
            w = r / math.sqrt(shape[1])
        elif name.endswith("weight"):
            w = 1.0 + 0.1 * r
        else:
            w = 0.02 * r
        out[name] = w.contiguous()
    return out
