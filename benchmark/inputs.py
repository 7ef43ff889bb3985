"""The one generator of the benchmark's inputs, driven by a traffic mix's
parameters (``traffic/<name>.json``) and a configuration's data shape.

- The graph: the traffic's law (``graph``: uniform, powerlaw, banded,
  chunglu) over the configuration's ``nodes`` and ``pairs``, drawn from
  the traffic's ``graph_seed`` (the dataset: the same in every run), and
  symmetrized on the device.
- From ``--seed``, on the device: the features (normal, or half-normal
  where the configuration's ``feature_law`` says so), the labels
  (uniform over the classes) and, for split ``i`` (0 is set-up's warm-up
  split, 1, 2, ... the window's), its train/validation/test masks (a
  permutation cut at the traffic's ``masks`` fractions), its initial
  parameters (the shapes and laws of the configuration's reference,
  ``manifest.REFERENCE``, one draw) and its dropout seed.
"""

from __future__ import annotations

import hashlib

import numpy as np
import scipy.sparse as sp
import torch

from benchmark import graphs


def derive(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``tags`` of the run seeded ``seed``."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def graph(config: dict, traffic: dict, device) -> sp.csr_matrix:
    data = config["data"]
    params = {k: v for k, v in traffic.items()
              if k in ("alpha", "halfwidth")}
    if traffic["graph"] == "chunglu":
        params["max_deg"] = data["top_expected_degree"]
    src, dst = graphs.draw_pairs(traffic["graph"], data["nodes"],
                                 data["pairs"], traffic["graph_seed"],
                                 **params)
    return graphs.symmetrize(src, dst, data["nodes"], device)


class Inputs:
    """The inputs of the run seeded ``seed`` on ``device``; the parameters'
    shapes and draw are those of ``reference``, the configuration's plain
    reference (``manifest.reference``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 adj: sp.csr_matrix, reference):
        data = config["data"]
        self.config, self.traffic, self.seed = config, traffic, seed
        self.reference = reference
        self.device = torch.device(device)
        self.n, self.f, self.c = data["nodes"], data["features"], \
            data["classes"]
        self.adj = adj
        self.shapes = reference.param_shapes(config["model"], self.f,
                                             self.c, self.n)

    def features(self) -> torch.Tensor:
        """Normal, or its absolute value where the configuration's
        ``feature_law`` is "half_normal" (non-negative features)."""
        x = torch.randn(self.n, self.f, device=self.device,
                        generator=generator(self.device, self.seed,
                                            "features"))
        law = self.config["data"].get("feature_law", "normal")
        if law == "half_normal":
            return x.abs_()
        if law != "normal":
            raise ValueError(f"unknown feature_law {law!r}")
        return x

    def labels(self) -> torch.Tensor:
        return torch.randint(0, self.c, (self.n,), device=self.device,
                             generator=generator(self.device, self.seed,
                                                 "labels"))

    def masks(self, split: int):
        perm = torch.randperm(self.n, device=self.device,
                              generator=generator(self.device, self.seed,
                                                  "masks", split))
        cuts = np.cumsum([0] + list(self.traffic["masks"]))
        ends = [int(x * self.n) for x in cuts]   # bench.py: n//2, 3n//4
        out = []
        for a, b in zip(ends[:-1], ends[1:]):
            m = torch.zeros(self.n, dtype=torch.bool, device=self.device)
            m[perm[a:b]] = True
            out.append(m)
        return tuple(out)

    def params(self, split: int) -> dict:
        return self.reference.init_params(
            self.shapes, generator(self.device, self.seed, "params", split),
            self.device)

    def dropout_seed(self, split: int) -> int:
        return derive(self.seed, "dropout", split) % 2**32
