"""Grouped matmul for sparse-MoE dispatch: hand-written CUDA kernels with
plain PyTorch beside them.

The port of `ray_tpu/ops/gmm.py`. Tokens are laid out sorted by expert,
each expert's segment padded up to a `block_m` boundary
(`aligned_group_layout`), so every `block_m`-row tile of `lhs` belongs to
one expert and `gmm(lhs, rhs, tile_group)` computes

    out[t*block_m:(t+1)*block_m] = lhs[t*block_m:(t+1)*block_m] @ rhs[tile_group[t]]

for lhs [M, K], rhs [E, K, N] and tile_group [M // block_m] int32. Two
kernels, built from `csrc/gmm.cu` at first use (`_build.py`):

- `grouped_matmul` launches K4, which replaces `_gmm_kernel`; the
  backward's dlhs is K4 on each expert's matrix read transposed;
- `transposed_grouped_matmul` launches K5, which replaces `_tgmm_kernel`:
  drhs[e] is the sum of lhs_t^T dout_t over the tiles t of expert e, and
  zeros for an expert with no tiles (the reference leaves NaN there).

Each wrapper takes its plain version (`_gmm_plain`, `_tgmm_plain`) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
`LAUNCHES` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from ._build import aligned, ptr, require_cuda, stream

# The kernels' row tile: the layout's block_m must be a multiple of it.
KERNEL_BLOCK_M = 128

# Kernel launches by kernel name, counted where each wrapper launches.
LAUNCHES: Dict[str, int] = {"gmm": 0, "tgmm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def aligned_group_layout(e_flat: torch.Tensor, num_groups: int, block_m: int = 128):
    """Tile-aligned destinations for group-sorted dispatch.

    e_flat [N] integer: the group of each row. Returns (order [N], dst [N],
    tile_group [m_pad // block_m] int32, m_pad): `order` sorts the rows by
    group (stably), dst is each sorted row's slot in the padded layout
    (every group's segment starts on a block_m boundary), tile_group maps
    every tile to its group, and m_pad is the padded row count, a Python
    int from N, num_groups and block_m alone. The same integers as the
    reference; nothing here waits for the device.
    """
    n = e_flat.shape[0]
    m_pad = -(-(n + num_groups * block_m) // block_m) * block_m
    dev = e_flat.device
    e_flat = e_flat.long()
    # bincount would read the largest id back to the host; a scatter does not.
    sizes = torch.zeros(num_groups, dtype=torch.long, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    aligned_sizes = (sizes + block_m - 1) // block_m * block_m
    starts = torch.cumsum(aligned_sizes, 0) - aligned_sizes
    raw_starts = torch.cumsum(sizes, 0) - sizes
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    rank = torch.arange(n, device=dev) - raw_starts[e_sorted]
    dst = starts[e_sorted] + rank
    tile_start = torch.arange(m_pad // block_m, device=dev) * block_m
    tile_group = (torch.searchsorted(starts, tile_start, right=True) - 1).clamp(
        0, num_groups - 1)
    return order, dst, tile_group.to(torch.int32), m_pad


# ------------------------------------------------------------ plain versions
# The kernels' arithmetic in PyTorch, in float32, written in the input's
# dtype: the CPU path, and what the kernels are held against on the card.


def _gmm_plain(lhs, rhs, tile_group, *, block_m, transpose_rhs=False):
    m, k = lhs.shape
    w = rhs.float().transpose(1, 2) if transpose_rhs else rhs.float()
    g = tile_group.long().clamp(0, rhs.shape[0] - 1)  # as the kernel reads it
    out = torch.bmm(lhs.float().view(m // block_m, block_m, k), w[g])
    return out.reshape(m, -1).to(lhs.dtype)


def _tgmm_plain(lhs, dout, tile_group, num_groups, *, block_m):
    m, k = lhs.shape
    tiles = m // block_m
    per_tile = torch.bmm(lhs.float().view(tiles, block_m, k).transpose(1, 2),
                         dout.float().view(tiles, block_m, -1))
    out = torch.zeros((num_groups, k, dout.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    return out.index_add_(0, tile_group.long(), per_tile).to(lhs.dtype)


# ------------------------------------------------------------ kernel launches

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # lhs, rhs, tile_group, out, m, k, n, num_groups, block_m, transpose_rhs,
    # is_bf16, stream
    "gmm": [_P] * 4 + [_I] * 7 + [_P],
    # lhs, dout, tile_group, out, m, k, n, num_groups, block_m, is_bf16, stream
    "tgmm": [_P] * 4 + [_I] * 6 + [_P],
}


def _launch(name: str, *args) -> None:
    _build.launch("gmm", name, _ARGTYPES[name], *args)
    LAUNCHES[name] += 1


def _check_layout(lhs, other, tile_group, block_m) -> None:
    if lhs.dim() != 2:
        raise ValueError("gmm kernels take a 2-D lhs [M, K]")
    m = lhs.shape[0]
    if block_m % KERNEL_BLOCK_M or m == 0 or m % block_m:
        raise ValueError(f"gmm kernels need block_m % {KERNEL_BLOCK_M} == 0 and "
                         f"0 < M % block_m == 0 (got M={m}, block_m={block_m})")
    if lhs.dtype not in _KERNEL_DTYPES or other.dtype != lhs.dtype:
        raise ValueError(f"gmm kernels take float32 or bfloat16 operands of one "
                         f"dtype (got {lhs.dtype}, {other.dtype})")
    if tile_group.dtype != torch.int32 or tile_group.shape != (m // block_m,):
        raise ValueError(f"tile_group must be int32 [M // block_m] = [{m // block_m}]")
    for t in (other, tile_group):
        if t.device != lhs.device:
            raise ValueError("all inputs must be on one device")


def _check_widths(*dims: int) -> None:
    if any(d == 0 or d % 8 for d in dims):
        raise ValueError(f"gmm kernels need K and N positive multiples of 8 "
                         f"(got {dims})")


def _check_gmm_args(lhs, rhs, tile_group, block_m, transpose_rhs) -> Tuple[int, int, int, int]:
    """Raises on what K4 does not take; returns (m, k, n, num_groups)."""
    _check_layout(lhs, rhs, tile_group, block_m)
    if rhs.dim() != 3:
        raise ValueError("gmm takes rhs [E, K, N]")
    m, k = lhs.shape
    e, rk, rn = rhs.shape
    k_rhs, n = (rn, rk) if transpose_rhs else (rk, rn)
    if k_rhs != k:
        raise ValueError(f"shape mismatch: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}, transpose_rhs={transpose_rhs}")
    _check_widths(k, n)
    return m, k, n, e


def _check_tgmm_args(lhs, dout, tile_group, block_m) -> Tuple[int, int, int]:
    """Raises on what K5 does not take; returns (m, k, n)."""
    _check_layout(lhs, dout, tile_group, block_m)
    if dout.dim() != 2 or dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"shape mismatch: lhs {tuple(lhs.shape)}, dout "
                         f"{tuple(dout.shape)}")
    m, k = lhs.shape
    _check_widths(k, dout.shape[1])
    return m, k, dout.shape[1]


def _gmm_cuda(lhs, rhs, tile_group, *, block_m, transpose_rhs=False):
    m, k, n, e = _check_gmm_args(lhs, rhs, tile_group, block_m, transpose_rhs)
    lhs, rhs, tile_group = aligned(lhs), aligned(rhs), tile_group.contiguous()
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        _launch("gmm", ptr(lhs), ptr(rhs), ptr(tile_group), ptr(out), m, k, n, e,
                block_m, int(transpose_rhs), int(lhs.dtype == torch.bfloat16),
                stream(lhs.device))
    return out


def _tgmm_cuda(lhs, dout, tile_group, num_groups, *, block_m):
    m, k, n = _check_tgmm_args(lhs, dout, tile_group, block_m)
    lhs, dout, tile_group = aligned(lhs), aligned(dout), tile_group.contiguous()
    out = torch.empty((num_groups, k, n), dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        _launch("tgmm", ptr(lhs), ptr(dout), ptr(tile_group), ptr(out), m, k, n,
                num_groups, block_m, int(lhs.dtype == torch.bfloat16),
                stream(lhs.device))
    return out


# ------------------------------------------------------------ public entries


def grouped_matmul(lhs, rhs, tile_group, *, block_m: int = 128,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """out [M, N] in lhs's dtype, each block_m-row tile of lhs times its
    group's matrix: rhs [E, K, N], or rhs [E, N, K] read transposed when
    `transpose_rhs`. K4 on CUDA tensors, the plain version on the CPU."""
    if lhs.device.type == "cpu":
        return _gmm_plain(lhs, rhs, tile_group, block_m=block_m,
                          transpose_rhs=transpose_rhs)
    require_cuda(lhs, "grouped_matmul")
    return _gmm_cuda(lhs, rhs, tile_group, block_m=block_m, transpose_rhs=transpose_rhs)


def transposed_grouped_matmul(lhs, dout, tile_group, num_groups: int, *,
                              block_m: int = 128) -> torch.Tensor:
    """out [E, K, N] in lhs's dtype: out[e] sums lhs_t^T dout_t over the
    tiles t with tile_group[t] == e, zeros where e has none. K5 on CUDA
    tensors, the plain version on the CPU."""
    if lhs.device.type == "cpu":
        return _tgmm_plain(lhs, dout, tile_group, num_groups, block_m=block_m)
    require_cuda(lhs, "transposed_grouped_matmul")
    return _tgmm_cuda(lhs, dout, tile_group, num_groups, block_m=block_m)


class _GroupedMatmul(torch.autograd.Function):
    """The reference's custom VJP: dlhs from K4 on the transposed expert
    matrices, drhs from K5."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_group, block_m):
        ctx.save_for_backward(lhs, rhs, tile_group)
        ctx.block_m = block_m
        return grouped_matmul(lhs, rhs, tile_group, block_m=block_m)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, tile_group = ctx.saved_tensors
        dout = dout.to(lhs.dtype)
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_matmul(dout, rhs, tile_group, block_m=ctx.block_m,
                                  transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = transposed_grouped_matmul(lhs, dout, tile_group, rhs.shape[0],
                                             block_m=ctx.block_m).to(rhs.dtype)
        return dlhs, drhs, None, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, tile_group: torch.Tensor,
        block_m: int = 128) -> torch.Tensor:
    """Grouped matmul, differentiable in lhs and rhs:
    out[t*bm:(t+1)*bm] = lhs[t*bm:(t+1)*bm] @ rhs[tile_group[t]].

    lhs [M, K] with M % block_m == 0, rows laid out so that each block_m
    tile belongs to one group (`aligned_group_layout`); rhs [E, K, N];
    tile_group [M // block_m] int32 with ids in [0, E).
    """
    return _GroupedMatmul.apply(lhs, rhs, tile_group, block_m)
