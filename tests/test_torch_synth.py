"""The port's synthetic corpora (``vettore_tpu_torch/synth.py``) on the CPU:
determinism per seed, ``round_bf16_device`` bit-equal to both packages'
host ``round_to_bf16`` (and to the JAX ``round_bf16_device``), and the
geometry the JAX generators have (the bits differ: JAX draws from Threefry,
the port from a ``torch.Generator``): unit rows before the bf16 rounding,
rows around unit centres at the cluster radius, noise at the given norm,
the token block's layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu import synth as jsynth
from vettore_tpu.ops.transport import is_bf16_exact
from vettore_tpu.ops.transport import round_to_bf16 as j_round
from vettore_tpu_torch import synth
from vettore_tpu_torch.ops.transport import round_to_bf16 as t_round

#: a unit row rounded to bf16 keeps its norm within d * 2**-9 (relative
#: rounding of each coordinate), far inside this
NORM_TOL = 0.01


def bits(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t).view(np.uint32)


def test_clustered_deterministic_and_bf16_exact():
    a = synth.clustered(500, 32, 16, 0.4, 7, device="cpu")
    b = synth.clustered(500, 32, 16, 0.4, 7, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (500, 32)
    assert (bits(a) == bits(b)).all()
    assert is_bf16_exact(a.numpy())
    # unit rows before rounding -> norms within bf16 rounding of 1
    assert (a.norm(dim=1) - 1.0).abs().max().item() < NORM_TOL
    c = synth.clustered(500, 32, 16, 0.4, 8, device="cpu")
    assert (bits(a) != bits(c)).any()


def _nearest(x):
    """Mean cosine of each row to its nearest other row."""
    sims = np.asarray(x, np.float64) @ np.asarray(x, np.float64).T
    np.fill_diagonal(sims, -2.0)
    return float(sims.max(axis=1).mean())


@pytest.mark.parametrize("radius", [0.2, 0.8])
def test_clustered_geometry_matches_jax(radius):
    """One cluster: two rows' cosine is 1 / (1 + r^2) (each row is a unit
    centre plus noise of norm ~r, renormalised), in both packages. Eight
    clusters: the nearest-neighbour and mean pairwise cosines of the two
    packages' corpora agree, and a tighter radius packs rows closer."""
    n, d = 1000, 128
    for x in (synth.clustered(n, d, 1, radius, 3, device="cpu").numpy(),
              np.asarray(jsynth.clustered(n, d, 1, radius, 3))):
        assert float(np.mean(x[:500] @ x[500:].T)) == pytest.approx(1 / (1 + radius**2),
                                                                    abs=0.02)
    got = synth.clustered(n, d, 8, radius, 4, device="cpu").numpy()
    want = np.asarray(jsynth.clustered(n, d, 8, radius, 4))
    assert _nearest(got) == pytest.approx(_nearest(want), abs=0.03)
    assert float(np.mean(got @ got.T)) == pytest.approx(float(np.mean(want @ want.T)), abs=0.1)
    assert _nearest(synth.clustered(n, d, 8, radius / 2, 4, device="cpu").numpy()) > _nearest(got)


def test_uniform_sphere_deterministic():
    a = synth.uniform_sphere(256, 24, 3, device="cpu")
    b = synth.uniform_sphere(256, 24, 3, device="cpu")
    assert (bits(a) == bits(b)).all()
    assert is_bf16_exact(a.numpy())
    assert (a.norm(dim=1) - 1.0).abs().max().item() < NORM_TOL
    # no cluster structure: mean pairwise |cos| stays small, as in JAX's
    sims = (a @ a.T - torch.eye(256)).abs().mean().item()
    jx = np.asarray(jsynth.uniform_sphere(256, 24, 3))
    want = np.abs(jx @ jx.T - np.eye(256)).mean()
    assert sims < 0.2 and sims == pytest.approx(want, abs=0.02)


def test_round_bf16_device_matches_host_rounding():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 33)).astype(np.float32) * np.float32(3.7)
    edge = np.array([0x3F808000, 0x3F818000, 0x00008000, 0x80000000, 0x7F7FFFFF, 0x7F7F7FFF,
                     0xFF7FFFFF, 0x7F800000, 0x7FC00000, 0xFFFFFFFF, 0x80018000],
                    dtype=np.uint32).view(np.float32)
    for arr in (x, edge):
        got = bits(synth.round_bf16_device(torch.from_numpy(arr)))
        assert (got == t_round(arr).view(np.uint32)).all()
        assert (got == j_round(arr).view(np.uint32)).all()
        assert (got == bits(jsynth.round_bf16_device(jnp.asarray(arr)))).all()


def test_perturbed_queries_shape_and_determinism():
    base = synth.clustered(200, 16, 8, 0.4, 1, device="cpu")
    q1 = synth.perturbed_queries(base, 32, 0.4, 5)
    q2 = synth.perturbed_queries(base, 32, 0.4, 5)
    assert q1.shape == (32, 16)
    assert (bits(q1) == bits(q2)).all()
    assert is_bf16_exact(q1.numpy())
    assert (q1.norm(dim=1) - 1.0).abs().max().item() < NORM_TOL
    # each query lies near a base row: the noise norm sets how near
    near = (q1 @ base.T).max(dim=1).values
    far = (synth.perturbed_queries(base, 32, 2.0, 5) @ base.T).max(dim=1).values
    assert near.mean().item() > far.mean().item()


def test_token_block_layout():
    docs = synth.clustered(50, 16, 4, 0.4, 2, device="cpu")
    blk = synth.token_block(docs, 4, 64, 8, 0.3, 9)
    again = synth.token_block(docs, 4, 64, 8, 0.3, 9)
    assert blk.shape == (64, 8, 16) and (bits(blk) == bits(again)).all()
    assert is_bf16_exact(blk.numpy())
    assert (blk[50:] == 0).all() and (blk[:, 4:] == 0).all()
    # tokens are the doc plus noise of norm ~token_noise
    noise = (blk[:50, :4] - docs[:, None, :]).norm(dim=-1)
    assert noise.mean().item() == pytest.approx(0.3, abs=0.05)
    want = np.asarray(jsynth.token_block(jnp.asarray(docs.numpy()), 4, 64, 8, 0.3, 9))
    jnoise = np.linalg.norm(want[:50, :4] - docs.numpy()[:, None, :], axis=-1)
    assert noise.mean().item() == pytest.approx(float(jnoise.mean()), abs=0.03)


def test_generators_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        synth.uniform_sphere(4, 4, 0)
