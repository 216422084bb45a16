"""The port's grouped matmul (ray_tpu_torch.ops.gmm) against the JAX package's,
on the CPU.

The port runs its plain PyTorch versions here (CPU tensors); the JAX side
runs its Pallas kernels in interpret mode. Both get the same float32 inputs
from numpy seeds and compute in float32, so only the order of summation
differs: 1e-5. The layout's integers are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import gmm as jgmm
from ray_tpu_torch.ops import gmm as tgmm

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers beside timing-sensitive runtime
    # tests; at these sizes one thread loses nothing.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _groups(n, experts, seed, empty=()):
    choices = [e for e in range(experts) if e not in empty]
    return np.random.RandomState(seed).choice(choices, n).astype(np.int32)


@pytest.mark.parametrize(
    "n,experts,block_m,empty",
    [
        (64, 4, 16, ()),
        (200, 8, 32, (3,)),        # an empty expert in the middle
        (50, 4, 128, (0, 3)),      # the first and the last expert empty
        (8192, 8, 128, ()),        # mixtral-small b2 s2048, top-2
    ],
)
def test_aligned_group_layout_matches_jax(n, experts, block_m, empty):
    e = _groups(n, experts, n, empty)
    want = jgmm.aligned_group_layout(jnp.asarray(e), experts, block_m=block_m)
    got = tgmm.aligned_group_layout(torch.from_numpy(e), experts, block_m=block_m)
    assert got[3] == want[3] and isinstance(got[3], int)
    assert got[2].dtype == torch.int32
    for name, g, w in zip(("order", "dst", "tile_group"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _problem(experts, k, n, pairs, seed, empty=()):
    """A layout of `pairs` rows over `experts`, lhs with the layout's zero
    padding rows, rhs, and an upstream gradient."""
    rng = np.random.RandomState(seed)
    e = _groups(pairs, experts, seed, empty)
    _, dst, tile_group, m = jgmm.aligned_group_layout(jnp.asarray(e), experts)
    lhs = np.zeros((m, k), np.float32)
    lhs[np.asarray(dst)] = rng.randn(pairs, k)
    rhs = (rng.randn(experts, k, n) / np.sqrt(k)).astype(np.float32)
    dout = np.zeros((m, n), np.float32)
    dout[np.asarray(dst)] = rng.randn(pairs, n)
    return lhs, rhs, np.asarray(tile_group), dout


def _jax_gmm(lhs, rhs, tile_group, dout):
    def loss(lhs, rhs):
        return (jgmm.gmm(lhs, rhs, jnp.asarray(tile_group)) * dout).sum()

    out = jgmm.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(tile_group))
    dlhs, drhs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    return np.asarray(out), np.asarray(dlhs), np.asarray(drhs)


def _torch_gmm(lhs, rhs, tile_group, dout, block_m=128):
    lt = torch.from_numpy(lhs).requires_grad_()
    rt = torch.from_numpy(rhs).requires_grad_()
    out = tgmm.gmm(lt, rt, torch.from_numpy(np.array(tile_group)), block_m)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), lt.grad.numpy(), rt.grad.numpy()


@pytest.mark.parametrize(
    "experts,k,n,pairs",
    [
        (4, 64, 128, 96),     # mixtral-tiny gate/up widths
        (4, 128, 64, 96),     # mixtral-tiny down
        (8, 72, 200, 300),    # widths off every tile
    ],
)
def test_gmm_and_grads_match_jax(interpret, experts, k, n, pairs):
    lhs, rhs, tile_group, dout = _problem(experts, k, n, pairs, seed=k + n)
    want = _jax_gmm(lhs, rhs, tile_group, dout)
    got = _torch_gmm(lhs, rhs, tile_group, dout)
    for name, g, w in zip(("out", "dlhs", "drhs"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


def test_empty_expert_gets_zero_drhs(interpret):
    """The reference's tgmm never flushes the block of an expert without
    tiles, so its drhs is NaN there; the port writes zeros, which is what
    the ragged oracle (lax.ragged_dot) gives. The other experts agree."""
    experts, empty = 4, 1
    lhs, rhs, tile_group, dout = _problem(experts, 64, 128, 96, seed=7, empty=(empty,))
    assert empty not in tile_group
    _, dlhs_j, drhs_j = _jax_gmm(lhs, rhs, tile_group, dout)
    _, dlhs_t, drhs_t = _torch_gmm(lhs, rhs, tile_group, dout)
    assert np.isnan(drhs_j[empty]).all()
    assert (drhs_t[empty] == 0).all()
    others = [e for e in range(experts) if e != empty]
    np.testing.assert_allclose(drhs_t[others], drhs_j[others], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dlhs_t, dlhs_j, atol=TOL, rtol=TOL)

    # The oracle: exact groups through ragged_dot, rows sorted by group.
    sizes = np.bincount(np.repeat(tile_group, 128), minlength=experts).astype(np.int32)
    oracle = jax.grad(
        lambda r: (jax.lax.ragged_dot(jnp.asarray(lhs), r, jnp.asarray(sizes)) * dout).sum()
    )(jnp.asarray(rhs))
    np.testing.assert_allclose(drhs_t, np.asarray(oracle), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block_m", [64, 256])
def test_gmm_follows_the_layouts_block_m(block_m):
    """The reference's tgmm hard-codes 128-row tiles; the port's takes
    block_m from the layout. Held against a per-row oracle in float64 (the
    port computes in float32)."""
    rng = np.random.RandomState(block_m)
    experts, k, n = 3, 16, 24
    e = torch.from_numpy(_groups(100, experts, block_m))
    _, dst, tile_group, m = tgmm.aligned_group_layout(e, experts, block_m=block_m)
    lhs = np.zeros((m, k)); lhs[dst.numpy()] = rng.randn(100, k)
    rhs, dout = rng.randn(experts, k, n), rng.randn(m, n)
    lhs, rhs, dout = (x.astype(np.float32) for x in (lhs, rhs, dout))
    got = _torch_gmm(lhs, rhs, tile_group.numpy(), dout, block_m=block_m)
    group = np.repeat(tile_group.numpy(), block_m)
    want_out = np.einsum("mk,mkn->mn", lhs, rhs[group])
    want_dlhs = np.einsum("mn,mkn->mk", dout, rhs[group])
    want_drhs = np.stack([lhs[group == g].T @ dout[group == g] for g in range(experts)])
    for name, g, w in zip(("out", "dlhs", "drhs"), got, (want_out, want_dlhs, want_drhs)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


def test_launch_counters_stay_zero_on_cpu():
    tgmm.reset_launch_counts()
    lhs, rhs, tile_group, dout = _problem(4, 64, 128, 96, seed=3)
    _torch_gmm(lhs, rhs, tile_group, dout)
    assert tgmm.LAUNCHES == {"gmm": 0, "tgmm": 0}


def test_wrappers_refuse_devices_without_a_path():
    lhs = torch.empty((128, 64), device="meta")
    tile_group = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tgmm.grouped_matmul(lhs, torch.empty((2, 64, 32), device="meta"), tile_group)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tgmm.transposed_grouped_matmul(lhs, torch.empty((128, 32), device="meta"),
                                       tile_group, 2)


def _args(m=256, k=64, n=128, e=4, dtype=torch.bfloat16, tg_dtype=torch.int32,
          tiles=None, rhs_dtype=None):
    lhs = torch.zeros((m, k), dtype=dtype)
    rhs = torch.zeros((e, k, n), dtype=rhs_dtype or dtype)
    tile_group = torch.zeros(m // 128 if tiles is None else tiles, dtype=tg_dtype)
    return lhs, rhs, tile_group


@pytest.mark.parametrize(
    "kw,block_m,transpose,match",
    [
        (dict(), 64, False, "block_m % 128"),
        (dict(m=200, tiles=1), 128, False, "M % block_m"),
        (dict(dtype=torch.float16), 128, False, "float32 or bfloat16"),
        (dict(rhs_dtype=torch.float32), 128, False, "one dtype"),
        (dict(tg_dtype=torch.int64), 128, False, "int32"),
        (dict(tiles=3), 128, False, "int32"),
        (dict(k=60), 128, False, "multiples of 8"),
        (dict(), 128, True, "shape mismatch"),
    ],
)
def test_gmm_argument_checks(kw, block_m, transpose, match):
    lhs, rhs, tile_group = _args(**kw)
    with pytest.raises(ValueError, match=match):
        tgmm._check_gmm_args(lhs, rhs, tile_group, block_m, transpose)


def test_argument_checks_accept_both_orientations_and_tgmm():
    lhs, rhs, tile_group = _args()
    assert tgmm._check_gmm_args(lhs, rhs, tile_group, 128, False) == (256, 64, 128, 4)
    dout = torch.zeros((256, 128), dtype=torch.bfloat16)
    assert tgmm._check_gmm_args(dout, rhs, tile_group, 128, True) == (256, 128, 64, 4)
    assert tgmm._check_tgmm_args(lhs, dout, tile_group, 128) == (256, 64, 128)
    with pytest.raises(ValueError, match="shape mismatch"):
        tgmm._check_tgmm_args(lhs, dout[:128], tile_group, 128)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm._check_tgmm_args(lhs, torch.zeros((256, 100), dtype=torch.bfloat16),
                              tile_group, 128)
