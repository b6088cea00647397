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


# ---- the fused pad: n_out, sigma past len(z) -------------------------------

def _gather_np(z, sigma, n_out):
    """numpy oracle of permute_gather: zeros where sigma leaves [0, len(z))
    and past len(sigma)."""
    out = np.zeros(n_out, z.dtype)
    s = np.asarray(sigma, np.int64)
    hit = (s >= 0) & (s < z.size)
    out[: s.size][hit] = z[s[hit]]
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("side", ["permute_in", "permute_out"])
def test_fused_pad_matches_reference_dispatch(rng, interpret, dtype, side):
    """The reference's permute_in/permute_out (zeros to the plan's length,
    the Pallas Benes apply, a slice) against the port's one fused gather
    into a longer output, and the port's own permute_in/permute_out."""
    import types

    import jax.numpy as jnp

    from g4s_tpu.engine import dispatch as ref_dispatch
    from g4s_tpu_torch.engine import dispatch as port_dispatch
    n = 5000
    perm = rng.permutation(n)
    inv = np.argsort(perm)
    vec = (perm if side == "permute_in" else inv)
    rg = types.SimpleNamespace(
        perm=jnp.asarray(perm), iperm=jnp.asarray(inv),
        route_in=ref.build_permute_plan(perm),
        route_out=ref.build_permute_plan(inv))
    x = rng.standard_normal(n).astype(dtype)
    want = np.asarray(getattr(ref_dispatch, side)(rg, jnp.asarray(x)))
    assert want.dtype == dtype
    plan = port.build_permute_plan(vec, device="cpu")
    n_out = plan.m + 128
    got = port.permute_gather(torch.from_numpy(x), plan.sigma, n_out=n_out)
    np.testing.assert_array_equal(got[:n].numpy(), want)
    assert got.shape == (n_out,) and not got[n:].any()
    pg = types.SimpleNamespace(perm=torch.from_numpy(perm.astype(np.int32)),
                               iperm=torch.from_numpy(inv.astype(np.int32)))
    if side == "permute_in":
        mine = port_dispatch.permute_in(pg, torch.from_numpy(x), n_out=n_out)
        np.testing.assert_array_equal(mine.numpy(), got.numpy())
    else:
        # the WSELL path hands permute_out its padded y
        y_pad = torch.from_numpy(np.concatenate([x, np.ones(200, dtype)]))
        mine = port_dispatch.permute_out(pg, y_pad)
        np.testing.assert_array_equal(mine.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sigma_past_z_reads_zero(rng, dtype):
    z = torch.from_numpy(rng.standard_normal(100)).to(dtype) + 1
    sigma = np.array([0, 99, 100, 101, 2 ** 31 - 1, -1, 5, 7], np.int32)
    got = port.permute_gather(z, torch.from_numpy(sigma), n_out=11)
    want = _gather_np(z.numpy(), sigma, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2:6].any() and not got[8:].any() and got[:2].all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rem", range(1, 8))
def test_unaligned_lengths(rng, dtype, rem):
    m = 8 * 37 + rem
    z = torch.from_numpy(rng.standard_normal(m - 3)).to(dtype)
    sigma = torch.from_numpy(rng.permutation(m).astype(np.int32))
    got = port.permute_gather(z, sigma, n_out=m + rem)
    np.testing.assert_array_equal(
        got.numpy(), _gather_np(z.numpy(), sigma.numpy(), m + rem))
    assert torch.equal(port.permute_gather(z, sigma), got[:m])


def test_fused_interface_rejects_bad_lengths():
    z, sigma = torch.zeros(10), torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        port.permute_gather(z, sigma, n_out=9)
    assert port.permute_gather(z, sigma[:0]).shape == (0,)
    assert not port.permute_gather(z, sigma[:0], n_out=3).any()
