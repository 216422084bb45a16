"""The port's flash attention (ray_tpu_torch.ops.attention) against the JAX
package's, on the CPU.

The port runs its plain PyTorch versions here (CPU tensors); the JAX side
runs its Pallas kernels in interpret mode. Both get the same float32
inputs from numpy seeds, so only the order of summation differs: forward
atol/rtol 1e-4, gradients 5e-4.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import attention as tattn

FWD_TOL = 1e-4
GRAD_TOL = 5e-4


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


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "h,hkv,tq,tk,causal",
    [
        (4, 2, 384, 512, True),   # GQA 4/2, Tq < Tk (end-aligned mask)
        (4, 2, 256, 256, True),
        (2, 2, 100, 130, False),
    ],
)
def test_attention_reference_matches_jax(h, hkv, tq, tk, causal):
    q, k, v = _rand((2, h, tq, 32), 0), _rand((2, hkv, tk, 32), 1), _rand((2, hkv, tk, 32), 2)
    want = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    _close(got, want, FWD_TOL)


KERNEL_CASES = [
    (512, 512, True),
    (384, 512, True),   # Tq < Tk
    (500, 500, True),   # padded tails
    (512, 512, False),
]


def _bhtd(tq, tk, seed, d=64, bh=2):
    return (_rand((bh, tq, d), seed), _rand((bh, tk, d), seed + 1),
            _rand((bh, tk, d), seed + 2), _rand((bh, tq, d), seed + 3))


@pytest.mark.parametrize("tq,tk,causal", KERNEL_CASES)
def test_flash_fwd_plain_matches_pallas(interpret, tq, tk, causal):
    q, k, v, _ = _bhtd(tq, tk, 10)
    scale = 1.0 / 8.0
    o_j, lse_j = jattn._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale, block_q=128, block_k=128,
    )
    o_t, lse_t = tattn._flash_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=scale,
    )
    assert lse_t.dtype == torch.float32 and lse_t.shape == (2, tq)
    _close(o_t, o_j, FWD_TOL)
    _close(lse_t, lse_j, FWD_TOL)


@pytest.mark.parametrize("tq,tk,causal", KERNEL_CASES)
def test_flash_bwd_plain_matches_pallas(interpret, tq, tk, causal):
    q, k, v, do = _bhtd(tq, tk, 20)
    scale = 1.0 / 8.0
    kw = dict(causal=causal, sm_scale=scale, block_q=128, block_k=128)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jattn._flash_fwd_pallas(jq, jk, jv, **kw)
    want = jattn._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, **kw)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = tattn.flash_bwd(t(q), t(k), t(v), t(o), t(lse), t(do),
                          causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize(
    "h,hkv,tq,tk,causal",
    [(2, 2, 512, 512, True), (4, 2, 256, 384, True), (2, 2, 256, 256, False)],
)
def test_flash_attention_grads_match_jax(interpret, h, hkv, tq, tk, causal):
    q, k, v = _rand((1, h, tq, 64), 30), _rand((1, hkv, tk, 64), 31), _rand((1, hkv, tk, 64), 32)
    w = _rand((1, h, tq, 64), 33)

    def loss_j(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, block_q=128,
                                  block_k=128, force_pallas=True)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, o_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o_t = tattn.flash_attention(*leaves, causal=causal)
    (o_t * torch.from_numpy(w)).sum().backward()
    _close(o_t.detach(), o_j, FWD_TOL)
    for leaf, g in zip(leaves, g_j):
        _close(leaf.grad, g, GRAD_TOL)


# The bf16 K2 and K3 on the card round p and dS to bf16 once (no lo part)
# before the dV, dK and dQ products. chip_smoke.py holds them to a normwise
# relative error of 1e-2 per 64-row tile against the float32 plain
# versions; an emulation of that rounding must fit the same limit.
SMOKE_REL_TOL = 1e-2
SMOKE_TILE = 64


def _to_bf16(x):
    return x.to(torch.bfloat16).float()


def _emulated_bf16_bwd(q, k, v, do, lse, delta, causal, sm_scale):
    """(dq, dk, dv) as the bf16 kernels round: p and dS rounded to bf16,
    float32 sums, outputs rounded to bf16; inputs already bf16 values."""
    s = torch.bmm(q, k.transpose(1, 2)) * sm_scale
    if causal:
        s = s.masked_fill(~tattn._causal_mask(q.shape[1], k.shape[1], s.device), tattn.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.bmm(do, v.transpose(1, 2)) - delta[..., None]) * sm_scale
    p, ds = _to_bf16(p), _to_bf16(ds)
    dq = torch.bmm(ds, k)
    dk = torch.bmm(ds.transpose(1, 2), q)
    dv = torch.bmm(p.transpose(1, 2), do)
    return tuple(_to_bf16(x) for x in (dq, dk, dv))


def _worst_tile_rel_err(got, want, tile=SMOKE_TILE):
    """Largest ||got - want|| / ||want|| over tiles of `tile` rows of T,
    for [BH, T, D] tensors (chip_smoke.py's per-tile normwise error)."""
    d2 = (got - want).pow(2).sum(dim=(0, 2))
    r2 = want.pow(2).sum(dim=(0, 2))
    pad = -d2.numel() % tile
    d2 = torch.nn.functional.pad(d2, (0, pad)).view(-1, tile).sum(1)
    r2 = torch.nn.functional.pad(r2, (0, pad)).view(-1, tile).sum(1)
    return float((d2 / r2.clamp_min(1e-30)).sqrt().max())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", [(512, 512), (384, 512)])
def test_bf16_rounding_of_p_and_ds_fits_the_smoke_limits(d, tq, tk):
    q, k, v, do = (_to_bf16(torch.from_numpy(x)) for x in _bhtd(tq, tk, 40, d=d))
    kw = dict(causal=True, sm_scale=1.0 / d**0.5)
    o, lse = tattn._flash_fwd_plain(q, k, v, **kw)
    delta = (do * o).sum(-1)
    dk_p, dv_p = tattn._flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    dq_p = tattn._flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    got = _emulated_bf16_bwd(q, k, v, do, lse, delta, **kw)
    for name, g, want in zip(("dq", "dk", "dv"), got, (dq_p, dk_p, dv_p)):
        err = _worst_tile_rel_err(g, want)
        # bf16 rounding of p, dS and the output: about 2e-3, far inside.
        assert 0 < err <= SMOKE_REL_TOL, (name, err)


# The bf16 K1 on the card runs an online softmax over 64-key tiles in the
# log2 unit and rounds p to bf16 for p V, while l sums the float p; o is
# rounded to bf16. chip_smoke.py holds it to a normwise relative error of
# 1e-2 per 64-row tile and lse to an absolute 1e-3.
SMOKE_LSE_ATOL = 1e-3
LOG2E = 1.4426950408889634


def _emulated_bf16_fwd(q, k, v, causal, sm_scale, block=SMOKE_TILE):
    """(o, lse) as the bf16 K1 computes them; inputs already bf16 values."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    visible = (tattn._causal_mask(tq, tk, q.device) if causal
               else torch.ones((tq, tk), dtype=torch.bool))
    m = torch.full((bh, tq, 1), tattn.NEG_INF)  # of s * scale * log2(e)
    l = torch.zeros((bh, tq, 1))
    acc = torch.zeros_like(q)
    for k0 in range(0, tk, block):
        x = torch.bmm(q, k[:, k0:k0 + block].transpose(1, 2)) * (sm_scale * LOG2E)
        x = x.masked_fill(~visible[:, k0:k0 + block], tattn.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.bmm(_to_bf16(p), v[:, k0:k0 + block])
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return _to_bf16(acc / l), (m * math.log(2.0) + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(512, 512), (384, 512), (300, 300)])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_fwd_emulation_fits_the_smoke_limits(interpret, d, tq, tk, causal):
    q, k, v, _ = (_to_bf16(torch.from_numpy(x)) for x in _bhtd(tq, tk, 50, d=d))
    kw = dict(causal=causal, sm_scale=1.0 / d**0.5)
    o, lse = _emulated_bf16_fwd(q, k, v, **kw)
    o_j, lse_j = jattn._flash_fwd_pallas(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                         block_q=128, block_k=128, **kw)
    refs = {"plain": tattn._flash_fwd_plain(q, k, v, **kw),
            "pallas": (torch.from_numpy(np.array(o_j)), torch.from_numpy(np.array(lse_j)))}
    for name, (o_ref, lse_ref) in refs.items():
        err = _worst_tile_rel_err(o, o_ref)
        # bf16 rounding of p and of o: about 2e-3, far inside.
        assert 0 < err <= SMOKE_REL_TOL, (name, err)
        assert float((lse - lse_ref).abs().max()) <= SMOKE_LSE_ATOL, name


def test_causal_rejects_more_queries_than_keys():
    q = torch.from_numpy(_rand((1, 2, 256, 64), 6))
    k = torch.from_numpy(_rand((1, 2, 128, 64), 7))
    with pytest.raises(ValueError, match="Tq <= Tk"):
        tattn.flash_attention(q, k, k, causal=True)


def test_launch_counters_stay_zero_on_cpu():
    tattn.reset_launch_counts()
    leaves = [torch.from_numpy(_rand((1, 2, 64, 16), s)).requires_grad_() for s in (1, 2, 3)]
    tattn.flash_attention(*leaves).sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)
    assert tattn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def test_wrappers_refuse_devices_without_a_path():
    q = torch.empty((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tattn.flash_fwd(q, q, q, causal=True, sm_scale=0.25)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tattn.flash_bwd(q, q, q, q, torch.empty((1, 64), device="meta"), q,
                        causal=True, sm_scale=0.25)


@pytest.mark.parametrize(
    "q_shape,k_shape,dtype,match",
    [
        ((2, 64, 136), (2, 64, 136), torch.bfloat16, "D <= 128"),
        ((2, 64, 60), (2, 64, 60), torch.bfloat16, "D % 8"),
        ((2, 64, 64), (2, 64, 64), torch.float16, "float32 or bfloat16"),
        ((2, 64, 64), (3, 64, 64), torch.float32, "shape mismatch"),
        ((2, 64, 64), (2, 0, 64), torch.float32, "non-empty"),
    ],
)
def test_kernel_argument_checks(q_shape, k_shape, dtype, match):
    q, k = torch.zeros(q_shape, dtype=dtype), torch.zeros(k_shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tattn._check_kernel_args(q, k, k)


def test_kernel_argument_checks_accept_lse_and_delta():
    q = torch.zeros((2, 64, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 96, 64), dtype=torch.bfloat16)
    rows = torch.zeros((2, 64), dtype=torch.float32)
    assert tattn._check_kernel_args(q, k, k, rows, rows) == (2, 64, 96, 64)
    with pytest.raises(ValueError, match="lse and delta"):
        tattn._check_kernel_args(q, k, k, rows.to(torch.bfloat16), rows)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_inputs_are_made_16_byte_aligned():
    base = torch.arange(65, dtype=torch.float32)
    shifted = base[1:].view(1, 8, 8)  # contiguous, data 4 bytes past the storage
    assert shifted.data_ptr() % 16 == 4
    fixed = tattn._aligned(shifted)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, shifted)
    assert tattn._aligned(base[:64]).data_ptr() == base.data_ptr()
