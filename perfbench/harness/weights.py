"""Seeded weights, made on the device in a few large calls.

A parameter spec ({name: (shape, init)}, reference/common.py) gives every
parameter's shape and how it starts: "normal" draws N(0, 0.02^2), "zeros"
and "ones" are constants (biases, LayerNorm, LayerScale). All the normal
draws come from one `torch.randn` of their total size on the device, from
a generator seeded with the run's seed, and are split into the
parameters; so the same seed gives the same state dict on the same
device, and the benchmark can make it again for the reference after the
program has been freed. The weights are float32, the type the program
keeps its parameters in (it computes in bfloat16 from them).
"""

from __future__ import annotations

import math

import torch

INIT_STD = 0.02


def make_state_dict(spec: dict, seed: int, device) -> dict:
    names = [n for n, (_, init) in spec.items() if init == "normal"]
    sizes = [math.prod(spec[n][0]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(INIT_STD)
    sd = {n: part.view(spec[n][0])
          for n, part in zip(names, flat.split(sizes))}
    for name, (shape, init) in spec.items():
        if init == "zeros":
            sd[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            sd[name] = torch.ones(shape, device=device)
        elif init != "normal":
            raise ValueError(f"unknown init {init!r} for {name}")
    return sd
