"""The corpus and queries of every cell, made on the device from a seed.

A frozen copy of the geometry of ``vettore_tpu_torch/synth.py``
(``clustered``, ``perturbed_queries``): unit rows in Gaussian clusters of
sigma = radius / sqrt(d) around unit centres, bf16-rounded f32; queries are
corpus rows plus Gaussian noise of norm ~``noise``, unit-normalised and
bf16-rounded. Each draw uses its own ``torch.Generator`` on the device, so
the same seed gives bit-identical arrays on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed: int, *path: int) -> int:
    """A 63-bit seed for the draw named by ``path`` under ``seed`` (any
    whole number, however large)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *map(int, path)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Nearest-even bfloat16 rounding, kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _unit_(x: torch.Tensor) -> torch.Tensor:
    return x.div_(torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def clustered(n: int, d: int, cluster_rows: int, radius: float, seed: int, device,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """``[n, d]`` unit rows in ``ceil(n / cluster_rows)`` Gaussian clusters,
    bf16-rounded f32, written into ``out`` when given."""
    gen = generator(device, seed)
    dev = gen.device
    centres = _unit_(torch.randn(max(1, math.ceil(n / cluster_rows)), d, device=dev,
                                 generator=gen))
    assign = torch.randint(0, centres.shape[0], (n,), device=dev, generator=gen)
    data = torch.randn(n, d, device=dev, generator=gen).mul_(radius / math.sqrt(d))
    data += centres[assign]
    del centres, assign
    rows = round_bf16(_unit_(data))
    if out is None:
        return rows
    out.copy_(rows)
    return out


def perturbed(base: torch.Tensor, noise: float, seed: int) -> torch.Tensor:
    """Queries from ``base`` (``[count, d]`` corpus rows, already picked):
    each plus Gaussian noise of norm ~``noise``, unit, bf16-rounded."""
    gen = generator(base.device, seed)
    d = base.shape[1]
    q = torch.randn(base.shape, device=gen.device, generator=gen).mul_(noise / math.sqrt(d))
    return round_bf16(_unit_(q.add_(base.float())))


def picks(total: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` row indices in ``[0, total)``, drawn with replacement."""
    gen = generator(device, seed)
    return torch.randint(0, total, (count,), device=gen.device, generator=gen)
