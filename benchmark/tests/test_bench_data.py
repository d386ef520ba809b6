"""The frozen generators: bit-identical arrays for the same seed."""

from __future__ import annotations

import torch

from benchmark.data import synth


def make(seed):
    x = synth.clustered(3000, 48, 100, 0.4, synth.subseed(seed, 1), "cpu")
    p = synth.picks(3000, 64, synth.subseed(seed, 2), "cpu")
    return x, p, synth.perturbed(x[p], 0.4, synth.subseed(seed, 3))


def test_same_seed_same_bits():
    for a, b in zip(make(2**31 + 99), make(2**31 + 99)):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


def test_other_seed_other_arrays():
    a, b = make(5), make(6)
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[2], b[2])


def test_geometry():
    x, _p, q = make(11)
    # bf16-rounded unit rows: exact in bfloat16, norms within bf16 rounding
    assert torch.equal(x.to(torch.bfloat16).float(), x)
    assert (torch.linalg.vector_norm(x, dim=1) - 1).abs().max() < 1e-2
    assert (torch.linalg.vector_norm(q, dim=1) - 1).abs().max() < 1e-2
    # 100-row clusters: a row's nearest other row is far closer than a random one
    s = x @ x.T
    s.fill_diagonal_(-2)
    assert s.max(dim=1).values.mean() > 0.7 > s.mean() + 0.5


def test_subseed_takes_any_whole_number():
    seeds = {synth.subseed(s, 1) for s in (0, 1, 2**31 + 5, 2**40, 2**63 + 1)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)
