"""The one generator of every traffic mix.

A mix is a data file, perfbench/traffic/<name>.json, of parameters:

  entry     the call the window drives, one of the family's entries
  batch     scenes (or pairs) in one call
  views     images of each scene
  height, width
            pixels of each image
  pool      distinct inputs made from the seed; the calls take them in
            turn, so consecutive calls never hand over the same arrays
  samples   calls of the window whose outputs are compared with the
            reference, drawn from the seed
  warmup    calls made during set-up, on the pool's inputs (every shape
            the window will use); a "train" entry checks exactly these
            steps against the reference
  why       one line: who sends such calls and what they exercise

plus entry-specific keyword objects (such as "infer"). Images are uniform
pixels in [0, 1], normalised with the family's mean and standard
deviation, so every seed gives the same sizes and only other values. A
"train" entry's pool holds synthetic batches (harness/synthetic.py)
instead, each from its own stream of the seed, so no two share a row.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import synthetic

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def make_pool(traffic: dict, mean, std, seed: int) -> list:
    """`pool` arrays of (batch, views, height, width, 3) float32, or for a
    "train" entry `pool` training batches."""
    if traffic["entry"] == "train":
        return [synthetic.make_batch(traffic["batch"], traffic["views"],
                                     traffic["height"], traffic["width"],
                                     [seed, k])
                for k in range(traffic["pool"])]
    rng = np.random.default_rng(seed)
    shape = (traffic["batch"], traffic["views"], traffic["height"],
             traffic["width"], 3)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    pool = []
    for _ in range(traffic["pool"]):
        px = rng.random(shape, dtype=np.float32)
        px -= mean
        px /= std
        pool.append(px)
    return pool
