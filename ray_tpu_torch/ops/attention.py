"""Flash attention: hand-written CUDA kernels with plain PyTorch beside them.

The port of `ray_tpu/ops/attention.py`. Public names and layouts are the
reference's: q [B, H, Tq, D]; k, v [B, Hkv, Tk, D] with H % Hkv == 0
(GQA); the causal mask is aligned to the END of the keys (kv-cache
semantics), so query row i sees keys <= i + Tk - Tq.

Three kernels, built from `csrc/` at first use (`_build.py`):

- `flash_fwd` launches K1 (`csrc/flash_fwd.cu`), which replaces
  `_fwd_kernel`;
- `flash_bwd` launches K2 and K3 (`csrc/flash_bwd.cu`), which replace
  `_bwd_dkv_kernel` and `_bwd_dq_kernel`.

Each wrapper takes its plain version (`_flash_fwd_plain`,
`_flash_bwd_dkv_plain`, `_flash_bwd_dq_plain`) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. `LAUNCHES` counts
the kernel launches, so a run can show that it went through them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ._build import aligned as _aligned
from ._build import ptr as _ptr
from ._build import require_cuda as _require_cuda
from ._build import stream as _stream

NEG_INF = -1e30
MAX_HEAD_DIM = 128

# Kernel launches by kernel name, counted where each wrapper launches.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    """[Tq, Tk] bool, True where query i may see key j (ends aligned)."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    return qpos >= kpos


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention; the numerics oracle for the kernels.

    Shapes: q [B, H, Tq, D]; k, v [B, Hkv, Tk, D] with H % Hkv == 0 (GQA).
    """
    h, tq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[1]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / d**0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(tq, k.shape[2], s.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


# ------------------------------------------------------------ plain versions
# The kernels' arithmetic in PyTorch, on [BH, T, D]: the CPU path, and what
# the kernels are held against on the card.


def _scores(q, k, causal, sm_scale) -> torch.Tensor:
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], s.device), NEG_INF)
    return s


def _flash_fwd_plain(q, k, v, *, causal, sm_scale):
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.bmm(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale):
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.bmm(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * sm_scale


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal, sm_scale):
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dk = torch.bmm(ds.transpose(1, 2), q.float())
    dv = torch.bmm(p.transpose(1, 2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal, sm_scale):
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.bmm(ds, k.float()).to(q.dtype)


# ------------------------------------------------------------ kernel launches

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [ctypes.c_float, _I, _I, _P],
    "flash_bwd_dq": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _I, _P],
}
_LIBRARY = {"flash_fwd": "flash_fwd", "flash_bwd_dkv": "flash_bwd",
            "flash_bwd_dq": "flash_bwd"}


def _launch(name: str, *args) -> None:
    _build.launch(_LIBRARY[name], name, _ARGTYPES[name], *args)
    LAUNCHES[name] += 1


def _check_kernel_args(q, k, v, *rows_f32) -> Tuple[int, int, int, int]:
    """Raises on what the kernels do not take; returns (bh, tq, tk, d)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [BH, T, D] tensors")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if k.shape != (bh, tk, d) or v.shape != (bh, tk, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take float32 or bfloat16 q, k, v of "
                         f"one dtype (got {q.dtype}, {k.dtype}, {v.dtype})")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"flash kernels need D <= {MAX_HEAD_DIM} and "
                         f"D % 8 == 0 (got D={d})")
    if tq == 0 or tk == 0 or bh == 0:
        raise ValueError("flash kernels need non-empty q and k")
    for t in (q, k, v, *rows_f32):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    for t in rows_f32:
        if t.dtype != torch.float32 or t.shape != (bh, tq):
            raise ValueError("lse and delta must be float32 [BH, Tq]")
    return bh, tq, tk, d


def _flash_fwd_cuda(q, k, v, *, causal, sm_scale):
    bh, tq, tk, d = _check_kernel_args(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
                bh, tq, tk, d, float(sm_scale), int(causal),
                int(q.dtype == torch.bfloat16), _stream(q.device))
    return o, lse


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal, sm_scale):
    bh, tq, tk, d = _check_kernel_args(q, k, v, lse, delta)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do.to(q.dtype)))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dkv", _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), bh, tq, tk, d,
                float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
                _stream(q.device))
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal, sm_scale):
    bh, tq, tk, d = _check_kernel_args(q, k, v, lse, delta)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do.to(q.dtype)))
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dq", _ptr(q), _ptr(k), _ptr(v), _ptr(do),
                _ptr(lse), _ptr(delta), _ptr(dq), bh, tq, tk, d,
                float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
                _stream(q.device))
    return dq


# ------------------------------------------------------------ public entries


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float):
    """(o, lse) for q [BH, Tq, D], k, v [BH, Tk, D]; o in q's dtype, lse
    [BH, Tq] float32. K1 on CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    _require_cuda(q, "flash_fwd")
    return _flash_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float):
    """(dq, dk, dv) given the forward's o and an lse [BH, Tq] float32,
    which may be a global one (ring attention). K2 and K3 on CUDA
    tensors, the plain versions on the CPU."""
    delta = (do.float() * o.float()).sum(dim=-1)  # [BH, Tq]
    if q.device.type == "cpu":
        dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                      causal=causal, sm_scale=sm_scale)
        dq = _flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                 causal=causal, sm_scale=sm_scale)
        return dq, dk, dv
    _require_cuda(q, "flash_bwd")
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                 causal=causal, sm_scale=sm_scale)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                            causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) on [BH, T, D]; saves (q, k, v, o, lse) for
    the backward kernels, as the reference's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do,
                               causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise (flash) attention with gradients.

    q [B, H, Tq, D]; k, v [B, Hkv, Tk, D], GQA via H % Hkv == 0. Runs the
    kernels for CUDA tensors at every shape (they mask ragged edges
    themselves) and the plain versions for CPU tensors.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if causal and tq > tk:
        # End-aligned causal semantics put the first tq - tk query rows
        # before every key; their softmax is over an empty set.
        raise ValueError(
            f"causal attention requires Tq <= Tk (got Tq={tq}, Tk={tk}): "
            "query rows are aligned to the END of the key sequence"
        )
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if h != hkv:
        # jnp.repeat's order: query head i reads KV head i // (H / Hkv).
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / d**0.5
    o = _FlashAttention.apply(
        q.reshape(b * h, tq, d), k.reshape(b * h, tk, d),
        v.reshape(b * h, tk, d), causal, scale,
    )
    return o.reshape(b, h, tq, d)
