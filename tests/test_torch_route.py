"""The port's static permutation (g4s_tpu_torch/ops/route.py) against the
reference's Clos/Benes plans: the JAX Pallas executor (interpret mode on
CPU) and its numpy oracle apply_permute_np. A permutation copies values, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from g4s_tpu.ops import route as ref
from g4s_tpu_torch.ops import route as port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("m0", [16384, 49152, 100000])
def test_apply_permute_matches_reference(rng, interpret, m0):
    import jax.numpy as jnp
    sigma = rng.permutation(m0)
    rplan = ref.build_permute_plan(sigma)
    pplan = port.build_permute_plan(sigma, device="cpu")
    assert pplan.m == rplan.m
    # the reference plan's permutation vector, recovered exactly
    full = ref.apply_permute_np(rplan, np.arange(rplan.m))
    np.testing.assert_array_equal(pplan.sigma.numpy(), full)
    z = rng.standard_normal(rplan.m).astype(np.float32)
    out = port.apply_permute(pplan, torch.from_numpy(z)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref.apply_permute_np(rplan, z))
    dev = np.asarray(ref.apply_permute(rplan, jnp.asarray(z, jnp.float32)))
    np.testing.assert_array_equal(out, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inverse_roundtrip(rng, dtype):
    m0 = 20000
    sigma = rng.permutation(m0)
    fwd = port.build_permute_plan(sigma, device="cpu")
    bwd = port.build_permute_plan(np.argsort(sigma), device="cpu")
    z = torch.from_numpy(rng.standard_normal(fwd.m)).to(dtype)
    back = port.apply_permute(bwd, port.apply_permute(fwd, z))
    assert torch.equal(back, z)


def test_permute_gather_is_plain_on_cpu(rng):
    z = torch.from_numpy(rng.standard_normal(300))
    sigma = torch.from_numpy(rng.integers(0, 300, 50).astype(np.int32))
    before = port.LAUNCHES
    assert torch.equal(port.permute_gather(z, sigma), z[sigma.long()])
    assert port.LAUNCHES == before


def test_plan_limits():
    with pytest.raises(NotImplementedError):
        port.build_permute_plan(np.arange(port.MAX_M + 1), device="cpu")
    with pytest.raises(NotImplementedError):
        ref.build_permute_plan(np.arange(ref.MAX_M + 1))
    assert (port.TILE, port.MAX_M) == (ref.TILE, ref.MAX_M)
    with pytest.raises(ValueError):
        port.build_permute_plan(np.array([0, 5, 1]), device="cpu")
    plan = port.build_permute_plan(np.arange(5), device="cpu")
    with pytest.raises(ValueError):
        port.apply_permute(plan, torch.zeros(5))
