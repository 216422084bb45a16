"""Ring attention: exact attention over a sequence-sharded process group.

The port of `ray_tpu/ops/ring_attention.py`. Each rank of the group holds
a [B, H, T/n, D] shard of q, k and v, the sequence split contiguously in
rank order. The k/v shards travel around the ring (`parallel.ring`) while
each rank computes one block of attention per step and folds it into a
running (o, lse) pair, so the full sequence is never gathered. The shift
of the next block's k/v is posted before the current block's kernels
run, so that exchange and compute overlap.

Every block runs the port's flash kernels through the public `flash_fwd`
(K1) and `flash_bwd` (K2 and K3), which take the plain versions only for
CPU tensors. The backward is a second ring pass given the GLOBAL (o,
lse): p = exp(s - lse) over a block sums to less than 1. Its dk/dv
accumulators are float32 and travel with their k/v shards, one hop
behind them (a rank sends an accumulator on once it has added its
block); one more hop after the last block brings each home.

Causality is by global block index (the group rank): the diagonal block
(the rank's own k/v, first) applies the in-block causal mask, the other
blocks none. A block wholly in the future (kv index > rank) contributes
exactly nothing in the reference, which computes it and then drops it
(lse -1e30 in the merge, gradients zeroed). Here no kernel runs for it;
its k/v still move on, so every rank shifts n - 1 times. The result is
the same: under causal sharding rank r runs r + 1 blocks in the forward
and r + 1 in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.ring import ring_shift, start_shift
from .attention import flash_bwd, flash_fwd


def _merge(o_a, lse_a, o_b, lse_b):
    """Folds two normalized partial results with weights exp(lse_i - lse).
    The running o stays float32 across the ring (one final downcast)."""
    m = torch.maximum(lse_a, lse_b)
    lse = m + torch.log(torch.exp(lse_a - m) + torch.exp(lse_b - m))
    w_a = torch.exp(lse_a - lse)[..., None]
    w_b = torch.exp(lse_b - lse)[..., None]
    return o_a.float() * w_a + o_b.float() * w_b, lse


def _visible(kv_idx: int, rank: int, causal: bool) -> bool:
    """Whether the block of k/v shard `kv_idx` reaches the queries of
    shard `rank`: every block without the causal mask, else those not
    wholly in the future."""
    return not causal or kv_idx <= rank


class _RingAttention(torch.autograd.Function):
    """o = attention(q, k, v) over the ring; q, k, v [B, H, T/n, D]."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        b, h, t, d = q.shape
        n, my = dist.get_world_size(group), dist.get_rank(group)

        def flat(x):
            return x.reshape(b * h, t, d)

        qf = flat(q)
        # The next block's k/v are on their way while this block computes.
        shift = start_shift([k, v], group)
        o, lse = flash_fwd(qf, flat(k), flat(v), causal=causal, sm_scale=scale)
        o = o.float()  # float32 accumulator across the ring
        for s in range(1, n):
            k_c, v_c = shift.wait()
            if s < n - 1:
                shift = start_shift([k_c, v_c], group)
            if not _visible((my - s) % n, my, causal):
                continue
            o_j, lse_j = flash_fwd(qf, flat(k_c), flat(v_c), causal=False,
                                   sm_scale=scale)
            o, lse = _merge(o, lse, o_j, lse_j)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o.reshape(b, h, t, d)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        b, h, t, d = q.shape
        n, my = dist.get_world_size(group), dist.get_rank(group)

        def flat(x):
            return x.reshape(b * h, t, d)

        qf, dof = flat(q), flat(do.contiguous())
        shift = start_shift([k, v], group)
        dq, dk, dv = flash_bwd(qf, flat(k), flat(v), o, lse, dof,
                               causal=causal, sm_scale=scale)
        dq = dq.float()
        # dk_rot, dv_rot: the float32 gradient of the k/v shard this rank
        # holds, summed over the ranks that held it before. They travel
        # WITH their shard, one hop behind it: each is sent on once this
        # rank has added its block. At the first step nobody has held the
        # arriving shard, so there is nothing to receive.
        dk_rot = dv_rot = None
        for s in range(1, n):
            acc = start_shift([dk_rot, dv_rot], group) if s > 1 else None
            k_c, v_c = shift.wait()
            if s < n - 1:
                shift = start_shift([k_c, v_c], group)
            visible = _visible((my - s) % n, my, causal)
            if visible:
                dq_j, dk_j, dv_j = flash_bwd(qf, flat(k_c), flat(v_c), o, lse, dof,
                                             causal=False, sm_scale=scale)
            if acc is not None:
                dk_rot, dv_rot = acc.wait()
            else:
                dk_rot = torch.zeros((b * h, t, d), dtype=torch.float32, device=q.device)
                dv_rot = torch.zeros_like(dk_rot)
            if visible:
                dq += dq_j.float()
                dk_rot += dk_j.float()
                dv_rot += dv_j.float()
        if n > 1:
            # One more hop completes the cycle: each accumulator home.
            dk_rot, dv_rot = ring_shift([dk_rot, dv_rot], group)
            dk = dk.float() + dk_rot
            dv = dv.float() + dv_rot
        return (dq.to(q.dtype).reshape(b, h, t, d), dk.to(k.dtype).reshape(b, h, t, d),
                dv.to(v.dtype).reshape(b, h, t, d), None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of this rank's shards q, k, v [B, H, T/n, D] (KV heads
    already repeated to H) over the sequence split across `group`, in
    rank order; returns this rank's o [B, H, T/n, D]."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention takes q, k, v of one shape [B, H, T/n, D] "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / d**0.5
    return _RingAttention.apply(q, k, v, group, causal, scale)


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = "seq",
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """`ring_attention` over the `seq_axis` group of `mesh` (a
    `DeviceMesh`), after repeating k and v [B, Hkv, T/n, D] to the H
    heads of q (query head i reads KV head i // (H / Hkv))."""
    h, hkv = q.shape[1], k.shape[1]
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    return ring_attention(q, k, v, group=mesh.get_group(seq_axis), causal=causal,
                          sm_scale=sm_scale)
