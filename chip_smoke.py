#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: the card's name and power limit;
2. build: every kernel source in `ray_tpu_torch/ops/csrc/`, in parallel;
   every kernel's registers and spills from ptxas, with the shared memory
   per block of the bf16 Hopper kernels (`fwd_sm90`, `dkv_sm90`,
   `dq_sm90`, `gmm_sm90` in both forms, `tgmm_sm90`), none of which may
   spill;
3. attention kernels: K1 (forward), K2 (dK, dV) and K3 (dQ) against their
   plain PyTorch versions, which run in float32 on the same bf16-rounded
   inputs, at the Llama path's shape (D 128), the Mixtral path's (D 64,
   and its GQA of 16 heads over 8) and at ragged, non-causal, float32,
   GQA and bf16 edge cases (D 72 and 96 on zero-filled columns, ragged
   Tq < Tk, Tq 777 under the causal mask, one tile), element-wise and by
   normwise relative error per tile; K1, K2 and K3 give bitwise-equal
   outputs over two launches; times at both paths' shapes of each kernel,
   its plain version and a library call as a yardstick the port never
   calls: `scaled_dot_product_attention` for K1, PyTorch's
   flash-attention backward for the K2 + K3 pair;
4. grouped-matmul kernels: K4 (gmm, and its dlhs form on transposed
   expert matrices) and K5 (tgmm) against their plain versions at the
   Mixtral path's shapes, from a real top-2 layout of 4096 tokens over 8
   experts, and at an empty expert (K5 writes zeros), one expert owning
   every tile, K and N off the kernel's tile, mixtral-tiny's widths, a
   layout of block_m 256, float32, and (K4 alone) tile ids past the last
   expert, which both K4 and its plain version clamp; K4, its dlhs form
   and K5 give bitwise-equal outputs over two launches; times of each,
   its plain version and `torch._grouped_mm` as the yardstick;
5. Llama train: `ray_tpu_torch.bench` at llama-1b, batch 2, sequence
   2048, bf16 parameters, one warm-up and three timed steps; the loss is
   finite and falls, and every kernel was launched as often as the model
   needs;
6. chunked loss: `chunked_causal_lm_loss` (chunk 1024) equals
   `causal_lm_loss` on the same parameters;
7. MoE dispatch: one mixtral-small layer in float32, the "gmm" dispatch
   (K4, K5) against the "ragged" oracle (`torch.matmul` per expert):
   logits and every gradient;
8. Mixtral train: mixtral-small at full width and depth (8 layers, 8
   experts, top-2), batch 2, sequence 2048, bf16 parameters, "gmm"
   dispatch, one warm-up and three timed steps with `moe_lm_loss`; the
   loss is finite and falls, and K1-K5 were launched as often as the
   model needs;
9. dispatch probe: `resolve_moe_dispatch` times "capacity" against "gmm"
   (its disk cache in a temporary directory); the pick is printed, not
   checked;
10. attention kernels at this slice's shapes: K1-K3 against their plain
   versions, as in phase 3, at the long-context sweep's (16 heads of 128,
   T 8192, 16384 and 32768, held on 16, 4 and 2 heads where the plain
   versions' float32 score matrices must fit, timed on all 16) and at
   GPT's (gpt2-large b4 s1024: 80 heads of 64); times as in phase 3;
11. GPT: a 2-layer model at gpt2-large's widths on the card against the
   same weights on the CPU's plain path (bf16 logits and loss); then
   gpt2-large at full width and depth (36 layers, float32 parameters,
   bf16 compute, remat), batch 4, sequence 1024, one warm-up and three
   timed steps; the loss is finite and falls, and K1-K3 were launched as
   often as the model needs;
12. long context: `ray_tpu_torch.bench.longctx_sweep` as the bench runs
   it (llama-1b, bf16 parameters, batch 1, T 8192, 16384 and 32768, 5
   timed steps each, chunked loss), with each point's peak memory; a
   later point may be recorded as out of memory; losses finite, and
   K1-K3 launched as often as the points need;
13. ring blocks in one process: K1 without the causal mask at the ring's
   per-rank shape (16 heads of 128, T 8192), held and timed as in phase
   10; then two blocks of one query shard (the diagonal, causal, and an
   earlier one) merged as ring attention merges them, the merged o and
   lse held against the plain attention over both blocks' keys, and K2
   and K3 given that GLOBAL (o, lse) on each block held against their
   plain versions on the same inputs;
14. the ring over 4 ranks sharing the card (`parallel.launch.spawn`,
   gloo, neighbour exchange through pinned host memory): each rank's
   backend and card are printed; ring attention at llama-1b's attention
   shape (b1, 16 heads of 128, T 32768 global) against single-card
   `flash_attention` on the gathered tensors, o and every gradient; then
   the sequence-parallel llama-1b train step (seq 4, b1, T 32768, bf16
   parameters, chunked loss, one step then three timed): every loss
   equals the same step's loss on one card from the same weights and
   ids, every rank ends with the same parameters, the losses are finite
   and fall, and K1-K3 were launched as often as the ring needs, summed
   over the ranks (future blocks run no kernel). FSDP and
   tensor parallelism do not run on one card, and the phase says so;
15. the pipeline over 2 ranks sharing the card (`parallel.pipeline`,
   gloo, activations and their gradients through pinned host memory):
   llama-1b's 22 decoder layers at full width as 2 stages of 11, 4
   microbatches of b1 s2048, bf16 parameters, x the seed-0 embedding of
   `RandomState(0)` ids; one pipelined forward and backward of mean(y^2)
   against `sequential_reference` on the card with the same layers (y and
   every stage's gradients, normwise per 64-row tile), then three timed
   SGD steps: every loss finite and equal to the same steps on one card,
   the loss falling, and K1-K3 launched on each rank as often as its stage's microbatches
   need (bubble ticks run no stage); the step of the slowest rank, the
   peak memory per rank and the bubble share (S - 1) / (M + S - 1);
16. expert parallelism over 4 ranks sharing the card (data 2 x expert 2,
   4 experts a rank): mixtral-small at full width and depth, b2 s2048
   (one row a data replica), bf16 parameters, remat "dots", "capacity"
   forced by the mesh, `moe_lm_loss` with AdamW; one step and three
   timed: every loss equal to the same steps on one card with
   "capacity", the ranks of a data pair holding equal parameters and the
   parameters that are not experts equal on all four, losses finite and
   falling, K1-K3 launched as often as the model needs, summed over the
   ranks; each rank's backend and card, the slowest rank's step and the
   peak memory per rank. The dense four-axis dryrun
   (`ray_tpu_torch.dryrun`) does not run on one card, and the phase says
   so.

The line before last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

# Tolerances of a bf16 kernel against its float32 plain version: o is
# rounded to bf16 (2^-8 relative), gradients also sum over thousands of
# terms in another order.
O_TOL = 2e-2
LSE_ATOL = 1e-3
GRAD_TOL = 3e-2
# Causal gradients shrink along the sequence (|dV_j| ~ 1/sqrt(j)), so an
# element-wise atol near their size cannot see a wrong late tile. Each
# output (o, dq, dk, dv) is also held to a normwise relative error,
# ||kernel - plain|| / ||plain||, over the whole tensor and over every
# tile of TILE rows of the sequence on its own. bf16 output rounding
# alone gives about 1e-3.
REL_TOL = 1e-2
TILE = 64
# float32 kernels against float32 plain versions: the kernels' products
# carry about 16 bits of mantissa (each float operand as bf16 hi + lo),
# and sums run in another order. Used for every check of a float32 case.
F32_TOL = 2e-4
CHUNKED_LOSS_RTOL = 1e-3
# K4 and K5 (bf16) against their float32 plain versions: each output is
# rounded to bf16 (2^-9 relative), and sums run in another order. The
# element-wise atol is GMM_TOL times the output's root mean square, since
# outputs grow with the rows summed (K5) or the width (K4). The normwise
# errors are taken over the whole output and over every GMM_TILE rows of it
# (K4, one layout tile) or every expert (K5).
GMM_TOL = 2e-2
GMM_TILE = 128

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

MAIN = dict(bh=32, tq=2048, tk=2048, d=128, causal=True)  # llama-1b b2 s2048
MIXTRAL_ATTN = dict(bh=32, tq=2048, tk=2048, d=64, causal=True)  # mixtral-small b2 s2048
BATCH, SEQ, TIMED_STEPS = 2, 2048, 3
# The long-context sweep's attention (llama-1b b1: 16 heads of 128):
# (heads, T, heads held against the plain versions, None for all).
LONG_ATTN = ((16, 8192, None), (16, 16384, 4), (16, 32768, 2))
# gpt2-large b4 s1024: 4 x 20 heads of 64.
GPT_BATCH, GPT_SEQ = 4, 1024
GPT_ATTN = dict(bh=GPT_BATCH * 20, tq=GPT_SEQ, tk=GPT_SEQ, d=64, causal=True)
# bf16 GPT logits on the card against the CPU's plain path: each side
# rounds activations to bf16 at other points (about 1% normwise at
# gpt2-tiny against the flax model, tests/test_torch_gpt.py).
GPT_LOGITS_REL = 2e-2
# The bench's default --steps: the sweep times max(5, steps // 2) steps.
LONGCTX_BENCH_STEPS = 10
# Ring attention: 4 ranks share the card; llama-1b at batch 1, T 32768,
# split into 4 shards of 8192 (16 heads of 128 each).
RING_RANKS, RING_SEQ, RING_HEADS, RING_D = 4, 32768, 16, 128
RING_TIMED_STEPS, RING_CHUNK = 3, 2048
# Each sequence-parallel loss against the same step on one card: bf16
# activations round at other points (the ring merges per-block o in
# float32 and rounds once; the single kernel rounds its own o), and the
# bf16 gradients are summed over the ranks in another order, which moves
# only AdamW updates whose gradient is near zero (a first step is about
# lr * sign(g)).
RING_LOSS_RTOL = 1e-3
# The pipeline: llama-1b's 22 layers as 2 stages of 11 on 2 ranks sharing
# the card, 4 microbatches of b1 s2048, SGD on mean(y^2) (the reference
# dryrun's loss and step). The dryrun's rate of 0.1 makes this loss rise
# on llama-1b's layers; at 1e-3 it falls.
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO, PIPE_LR = 2, 11, 4, 1e-3
# Expert parallelism: mixtral-small on data 2 x expert 2, 4 ranks sharing
# the card.
EXPERT_DATA, EXPERT_EP = 2, 2
# mixtral-small b2 s2048: 4096 tokens routed top-2 over 8 experts, hidden
# 1024, expert MLP 3584.
MOE_TOKENS, MOE_EXPERTS, MOE_TOPK, MOE_D, MOE_F = BATCH * SEQ, 8, 2, 1024, 3584
SOURCES = {
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:75"),
    "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:201"),
    "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:262"),
    "gmm": ("ray_tpu_torch/ops/csrc/gmm.cu", "ray_tpu/ops/gmm.py:36"),
    "tgmm": ("ray_tpu_torch/ops/csrc/gmm.cu", "ray_tpu/ops/gmm.py:64"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_errs(got, want, tile=TILE):
    """Normwise relative error of `got` [..., T, D] against `want`: over
    the whole tensor, and the largest over tiles of `tile` rows of T."""
    import torch.nn.functional as F

    t = got.shape[-2]
    d2 = (got - want).pow(2).sum(-1).reshape(-1, t).sum(0)
    r2 = want.pow(2).sum(-1).reshape(-1, t).sum(0)
    pad = -t % tile
    d2t = F.pad(d2, (0, pad)).view(-1, tile).sum(1)
    r2t = F.pad(r2, (0, pad)).view(-1, tile).sum(1)
    whole = float((d2.sum() / r2.sum().clamp_min(1e-30)).sqrt())
    worst = float((d2t / r2t.clamp_min(1e-30)).sqrt().max())
    return whole, worst


def assert_close(name, got, want, atol, rtol, rel=None, tile=TILE):
    """Element-wise allclose and, where `rel` is given, both errors of
    `rel_errs` (tiles of `tile` rows) at most `rel`. Returns [max |got -
    want|, normwise relative error, worst tile's], the last two 0 where
    `rel` is None."""
    import torch

    err = max_err(got, want)
    got, want = got.detach().float(), want.detach().float()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, atol=atol, rtol=rtol)
    check(ok, f"{name}: max |kernel - plain| = {err:.3e} "
              f"(atol {atol}, rtol {rtol})")
    if rel is None:
        return [err, 0.0, 0.0]
    # The worst tile's error bounds the whole tensor's from above.
    whole, worst_tile = rel_errs(got, want, tile)
    check(worst_tile <= rel, f"{name}: normwise relative error {whole:.3e}, "
                             f"worst {tile}-row tile {worst_tile:.3e} (limit {rel})")
    return [err, whole, worst_tile]


def worst(*errs):
    """Element-wise max of `assert_close` results."""
    return [max(col) for col in zip(*errs)]


def fmt(e) -> str:
    return f"max|err| {e[0]:.3e}, rel {e[1]:.2e}, tile rel {e[2]:.2e}"


# Cycles the card spins before a timed run (a few ms), long enough for the
# host to queue every timed launch behind it.
SPIN_CYCLES = 10_000_000


def time_ms(fn, iters: int = 10) -> float:
    """Device time per call of `fn`: CUDA events around `iters` calls,
    queued while the card spins, so that the host's time between launches
    (the wrappers' Python and ctypes work) is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(q, k) pairs the causal (end-aligned) mask lets through."""
    if not causal:
        return tq * tk
    return tq * (tk - tq + 1) + tq * (tq - 1) // 2


def bound(bytes_moved: float, flops: float, flops_rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def ptxas_kernels(report: str):
    """[(kernel, registers, spill bytes)] from an `nvcc -Xptxas -v`
    report; a kernel of namespace `flash` or `grouped` is named as in its
    source, with an integer or bool template argument (`dkv_sm90<128>`,
    `gmm_sm90<true>`)."""
    import re

    found, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            m = re.match(r"_ZN(?:5flash|7grouped)(\d+)(\w+)", name)
            if m:
                n, rest = int(m.group(1)), m.group(2)
                t = re.match(r"IL([ib])(\d+)E", rest[n:])
                if t and t.group(1) == "b":
                    name = rest[:n] + ("<true>" if t.group(2) == "1" else "<false>")
                else:
                    name = rest[:n] + (f"<{t.group(2)}>" if t else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append((name, int(m.group(1)), spill))
    return found


# The bf16 Hopper kernels of each source: (library, C function giving the
# dynamic shared memory per block, its arguments).
SM90_KERNELS = {
    "fwd_sm90<64>": ("flash_fwd", "flash_fwd_sm90_smem_bytes", (64,)),
    "fwd_sm90<128>": ("flash_fwd", "flash_fwd_sm90_smem_bytes", (128,)),
    "dkv_sm90<64>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (64, 0)),
    "dkv_sm90<128>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (128, 0)),
    "dq_sm90<64>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (64, 1)),
    "dq_sm90<128>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (128, 1)),
    "gmm_sm90<false>": ("gmm", "gmm_sm90_smem_bytes", ()),
    "gmm_sm90<true>": ("gmm", "gmm_sm90_smem_bytes", ()),
    "tgmm_sm90": ("gmm", "tgmm_sm90_smem_bytes", (MOE_EXPERTS,)),
}


def report_build(build) -> None:
    """Prints every kernel's registers and spills, and the shared memory
    per block of the bf16 Hopper kernels; fails if one of those is
    missing from the reports or spills."""
    import ctypes

    def smem(lib, fn_name, args):
        fn = getattr(build.library(lib), fn_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
        return fn(*args)

    seen = set()
    for lib in ("flash_fwd", "flash_bwd", "gmm"):
        parts = []
        for name, regs, spill in ptxas_kernels(build.ptxas_report(lib)):
            text = f"{name} {regs} registers, {spill} spill bytes"
            if name in SM90_KERNELS:
                check(spill == 0, f"ptxas: {name} spills {spill} bytes")
                text += f", {smem(*SM90_KERNELS[name])} bytes of shared memory"
                seen.add(name)
            parts.append(text)
        print(f"ptxas {lib}.cu: " + "; ".join(parts), flush=True)
    check(seen == set(SM90_KERNELS), f"ptxas reports lack {set(SM90_KERNELS) - seen}")


def library_flash_bwd(q, k, v, do, causal: bool, scale: float):
    """A call of PyTorch's own flash-attention backward on [B, H, T, D]
    inputs, with o and lse from its own forward; returns (dq, dk, dv)."""
    import torch

    aten = torch.ops.aten
    o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False, scale=scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed, offset,
        scale=scale)


def attention_cases(A, seed):
    """(case, rand): `case` holds K1-K3 against their plain versions at
    one shape and, where `timed`, returns each kernel's numbers there;
    `rand` draws bf16 (or `dtype`) normal tensors on the card from
    `seed`."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(bh, tq, tk, d, causal, dtype=torch.bfloat16, timed=False, check_bh=None):
        """With `check_bh`, the kernels run on all `bh` heads and are held
        against the plain versions on the first `check_bh` of them, where
        the plain versions are also timed: at long T the float32 score
        matrices of every head would not fit on the card."""
        cb = check_bh or bh
        tag = f"bh{bh} tq{tq} tk{tk} d{d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
        if cb < bh:
            tag += f", held on {cb} heads"
        q, k, v, do = rand(bh, tq, d, dtype=dtype), rand(bh, tk, d, dtype=dtype), \
            rand(bh, tk, d, dtype=dtype), rand(bh, tq, d, dtype=dtype)
        qf, kf, vf, dof = (x[:cb].float() for x in (q, k, v, do))
        kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
        f32 = dtype == torch.float32
        o_tol = F32_TOL if f32 else O_TOL
        g_tol = F32_TOL if f32 else GRAD_TOL
        lse_tol = F32_TOL if f32 else LSE_ATOL
        rel = F32_TOL if f32 else REL_TOL

        o, lse = A._flash_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = A._flash_fwd_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        e_fwd = worst(assert_close(f"K1 o [{tag}]", o[:cb], o_p, o_tol, o_tol, rel),
                      assert_close(f"K1 lse [{tag}]", lse[:cb], lse_p, lse_tol, 0.0))
        # The backward kernels take the plain forward's lse and delta (on
        # the heads not held, K1's), so each is held against its plain
        # version on identical inputs.
        delta_p = (dof * o_p).sum(-1)
        lse_in, delta = lse_p, delta_p
        if cb < bh:
            lse_in = torch.cat([lse_p, lse[cb:]])
            delta = torch.cat([delta_p, (do[cb:].float() * o[cb:].float()).sum(-1)])
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dk_p, dv_p = A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta_p, **kw)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        dq_p = A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta_p, **kw)
        torch.cuda.synchronize()
        e_dkv = worst(assert_close(f"K2 dk [{tag}]", dk[:cb], dk_p, g_tol, g_tol, rel),
                      assert_close(f"K2 dv [{tag}]", dv[:cb], dv_p, g_tol, g_tol, rel))
        e_dq = assert_close(f"K3 dq [{tag}]", dq[:cb], dq_p, g_tol, g_tol, rel)
        print(f"kernels [{tag}]: K1 {fmt(e_fwd)}; K2 {fmt(e_dkv)}; "
              f"K3 {fmt(e_dq)}; limit rel {rel}: ok", flush=True)
        if not timed:
            return None
        # One writer per output: a second launch gives the same bits.
        o2, lse2 = A._flash_fwd_cuda(q, k, v, **kw)
        dk2, dv2 = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dq2 = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        same = all(torch.equal(x, y) for x, y in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2),
                                                    (dq, dq2)))
        check(same, f"K1/K2/K3 [{tag}]: two launches on the same inputs differ")
        print(f"deterministic [{tag}]: o, lse, dk, dv and dq bitwise equal over two launches",
              flush=True)

        el = q.element_size()
        pairs = bh * visible_pairs(tq, tk, causal)
        qb, kb = bh * tq * d * el, bh * tk * d * el
        rows = bh * tq * 4  # one float32 per q row (lse, delta)
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        res = {}
        res["flash_fwd"] = dict(
            max_abs_err=e_fwd[0],
            ms=time_ms(lambda: A._flash_fwd_cuda(q, k, v, **kw)),
            plain_ms=time_ms(lambda: A._flash_fwd_plain(qf, kf, vf, **kw)),
            bound=bound(2 * qb + 2 * kb + rows, 4 * d * pairs, rate),
        )
        b, h = 2, bh // 2
        q4, k4, v4, do4 = (t.view(b, h, -1, d) for t in (q, k, v, do))
        res["flash_fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        # The library's flash backward gives dq, dk and dv in one call from
        # its own forward's o and lse: one yardstick for the K2 + K3 pair,
        # held to the plain version first (on the held heads) so that it
        # computes the same.
        lib_bwd = library_flash_bwd(q4, k4, v4, do4, causal, kw["sm_scale"])
        lib_held = lib_bwd if cb == bh else library_flash_bwd(
            *(t[:cb].view(1, cb, -1, d) for t in (q, k, v, do)), causal, kw["sm_scale"])
        for name, got, want in zip(("dq", "dk", "dv"), lib_held(), (dq_p, dk_p, dv_p)):
            assert_close(f"library {name} [{tag}]", got.reshape(cb, -1, d), want,
                         g_tol, g_tol, rel)
        del lib_held
        pair_lib_ms = time_ms(lib_bwd)
        res["flash_bwd_dkv"] = dict(
            max_abs_err=e_dkv[0],
            ms=time_ms(lambda: A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta_p,
                                                            **kw)),
            bound=bound(2 * qb + 4 * kb + 2 * rows, 8 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        res["flash_bwd_dq"] = dict(
            max_abs_err=e_dq[0],
            ms=time_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta_p,
                                                           **kw)),
            bound=bound(3 * qb + 2 * kb + 2 * rows, 6 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        held = "" if cb == bh else f" on {cb} of {bh} heads"
        for name, r in res.items():
            lib = "" if name == "flash_fwd" else " for dq, dk and dv together"
            print(f"time {name} [{tag}]: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms{held}, bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}), library {r['library_ms']:.3f} ms{lib}",
                  flush=True)
        pair = res["flash_bwd_dkv"]["ms"] + res["flash_bwd_dq"]["ms"]
        print(f"time K2 + K3 [{tag}]: {pair:.3f} ms, library {pair_lib_ms:.3f} ms "
              f"(dq, dk and dv in one call)", flush=True)
        return res

    return case, rand


def phase_kernels(A):
    """Holds K1-K3 against their plain versions; returns each kernel's
    numbers at the main path's shape."""
    import torch

    case, rand = attention_cases(A, seed=0)
    main = case(**MAIN, timed=True)
    # The Mixtral path's shape (mixtral-small b2 s2048: 16 heads of 64),
    # timed too: its times stand beside the Llama shape's in PERF.md.
    case(**MIXTRAL_ATTN, timed=True)
    case(8, 1000, 1500, 128, True)           # ragged tails, Tq < Tk
    case(8, 777, 1024, 64, False)            # non-causal, ragged q
    case(4, 900, 600, 128, False)            # non-causal, Tq > Tk
    case(4, 300, 300, 72, True, dtype=torch.float32)  # float32, D % 16 != 0
    case(2, 256, 256, 128, True, dtype=torch.float32)  # float32 at the most shared memory
    case(2, 64, 64, 8, True)                 # one tile, smallest D
    # bf16 edges of the Hopper K1-K3: the 128-wide instance on
    # zero-filled columns, ragged Tq < Tk under the causal mask (Tq 777:
    # lse rows stored one by one), one block.
    case(4, 1000, 1100, 72, True)
    case(4, 1000, 1100, 96, True)
    case(4, 777, 1000, 128, True)
    case(4, 777, 1000, 64, True)
    case(1, 64, 64, 128, True)

    def gqa(b, h, hkv, t, d):
        """GQA through the public entry point, forward and backward, with
        o and every gradient held element-wise and per TILE rows."""
        q, k, v = rand(b, h, t, d), rand(b, hkv, t, d), rand(b, hkv, t, d)
        do = rand(b, h, t, d)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = A.flash_attention(*leaves, causal=True)
        o.backward(do)
        ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
        o_r = A.attention_reference(*ref_leaves, causal=True)
        o_r.backward(do.float())
        torch.cuda.synchronize()
        tag = f"GQA b{b} h{h} hkv{hkv} t{t} d{d}"
        errs = [assert_close(f"{tag} o", o, o_r, O_TOL, O_TOL, REL_TOL)]
        for name, x, xr in zip(("dq", "dk", "dv"), leaves, ref_leaves):
            errs.append(assert_close(f"{tag} {name}", x.grad, xr.grad, GRAD_TOL, GRAD_TOL,
                                     REL_TOL))
        print(f"kernels [{tag} through flash_attention]: {fmt(worst(*errs))}; "
              f"limit rel {REL_TOL}: ok", flush=True)

    gqa(2, 16, 4, 1024, 128)
    gqa(2, 16, 8, SEQ, 64)  # the Mixtral path's attention: 16 heads over 8 KV heads
    return main


def library_grouped_mm(lhs, rhs, dout, tile_group, num_groups, block_m=128):
    """A yardstick the port never calls: `torch._grouped_mm` over each
    expert's row range of the layout (offsets from tile_group), as calls
    for K4, its dlhs form and K5; None where this install's PyTorch does
    not take these inputs (then there is no one library call to time)."""
    import torch

    groups = torch.arange(num_groups, dtype=torch.int32, device=lhs.device)
    offs = (torch.searchsorted(tile_group, groups, right=True) * block_m).to(torch.int32)
    calls = {
        "gmm": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
        "gmm_dlhs": lambda: torch._grouped_mm(dout, rhs.transpose(1, 2), offs=offs),
        "tgmm": lambda: torch._grouped_mm(lhs.t(), dout, offs=offs),
    }
    try:
        for call in calls.values():
            call()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError) as exc:  # the yardstick only
        print(f"library: torch._grouped_mm does not take these inputs ({exc}); "
              "library_ms is null", flush=True)
        return None
    return calls


def phase_gmm(G):
    """Holds K4 and K5 against their plain versions; returns each kernel's
    numbers at the Mixtral path's gate/up shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def routed(tokens, experts, skip=(), block_m=128):
        """(dst, tile_group, m) of a top-2 layout of random router logits,
        with the experts in `skip` never chosen."""
        logits = torch.randn(tokens, experts, generator=gen, device="cuda")
        logits[:, list(skip)] = -math.inf
        e_flat = logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1)
        _, dst, tile_group, m = G.aligned_group_layout(e_flat, experts, block_m)
        return dst, tile_group, m

    def case(tag, dst, tile_group, m, e, k, n, dtype=torch.bfloat16, timed=False, empty=(),
             block_m=128, k5=True):
        """K4 (lhs [m, k] @ rhs [e, k, n]), its dlhs form (dout [m, n] @
        rhs^T) and, unless not `k5`, K5 (lhs^T dout per expert). Rows
        outside `dst` are the layout's zero rows, as the model fills them
        (all rows where dst is None)."""
        def rows(width, scale=1.0):
            if dst is None:
                return rand(m, width, dtype=dtype, scale=scale)
            x = torch.zeros((m, width), dtype=dtype, device="cuda")
            x[dst] = rand(dst.numel(), width, dtype=dtype, scale=scale)
            return x

        lhs, dout = rows(k), rows(n)
        rhs = rand(e, k, n, dtype=dtype, scale=k ** -0.5)
        lf, rf, df = lhs.float(), rhs.float(), dout.float()
        f32 = dtype == torch.float32
        tol = F32_TOL if f32 else GMM_TOL
        rel = F32_TOL if f32 else REL_TOL
        kw = dict(block_m=block_m)

        def close(name, got, want, per_expert=False):
            atol = tol * float(want.pow(2).mean().sqrt())
            if per_expert:  # [E, K, N] as E rows, one tile each
                return assert_close(name, got.view(1, e, -1), want.view(1, e, -1), atol, tol,
                                    rel, tile=1)
            return assert_close(name, got, want, atol, tol, rel, tile=GMM_TILE)

        out = G._gmm_cuda(lhs, rhs, tile_group, **kw)
        dlhs = G._gmm_cuda(dout, rhs, tile_group, transpose_rhs=True, **kw)
        torch.cuda.synchronize()
        want = G._gmm_plain(lf, rf, tile_group, **kw)
        want_t = G._gmm_plain(df, rf, tile_group, transpose_rhs=True, **kw)
        e_gmm = worst(close(f"K4 [{tag}]", out, want),
                      close(f"K4 dlhs [{tag}]", dlhs, want_t))
        if not k5:
            print(f"gmm kernels [{tag}]: K4 {fmt(e_gmm)}; limit rel {rel}: ok", flush=True)
            return None
        drhs = G._tgmm_cuda(lhs, dout, tile_group, e, **kw)
        want_d = G._tgmm_plain(lf, df, tile_group, e, **kw)
        e_tgmm = close(f"K5 [{tag}]", drhs, want_d, per_expert=True)
        for x in empty:
            check(bool((drhs[x] == 0).all()), f"K5 [{tag}]: expert {x} has no tiles, "
                                              f"but its drhs is not all zeros")
        print(f"gmm kernels [{tag}]: K4 {fmt(e_gmm)}; K5 {fmt(e_tgmm)}; "
              f"limit rel {rel}{'; empty experts ' + str(list(empty)) + ' zero' if empty else ''}"
              f": ok", flush=True)
        if not timed:
            return None
        # One writer per output tile: a second launch gives the same bits.
        again = {"K4": (out, G._gmm_cuda(lhs, rhs, tile_group, **kw)),
                 "K4 dlhs": (dlhs, G._gmm_cuda(dout, rhs, tile_group, transpose_rhs=True, **kw)),
                 "K5": (drhs, G._tgmm_cuda(lhs, dout, tile_group, e, **kw))}
        for name, (first, second) in again.items():
            check(torch.equal(first, second), f"{name} [{tag}]: two launches on the same "
                                              f"inputs differ")
        print(f"deterministic [{tag}]: K4, K4 dlhs and K5 bitwise equal over two launches",
              flush=True)

        el = lhs.element_size()
        flops = 2 * m * k * n
        moved = (m * k + e * k * n + m * n) * el  # each input read once, the output written once
        rate = F32_FLOPS if f32 else BF16_FLOPS
        lib = library_grouped_mm(lhs, rhs, dout, tile_group, e)
        wants = {"gmm": want, "gmm_dlhs": want_t, "tgmm": want_d}
        lib_ms = dict.fromkeys(wants)
        for name, want_lib in wants.items() if lib else ():
            close(f"library {name} [{tag}]", lib[name](), want_lib, per_expert=name == "tgmm")
            lib_ms[name] = time_ms(lib[name])
        res = {
            "gmm": dict(max_abs_err=e_gmm[0],
                        ms=time_ms(lambda: G._gmm_cuda(lhs, rhs, tile_group, **kw)),
                        plain_ms=time_ms(lambda: G._gmm_plain(lf, rf, tile_group, **kw)),
                        bound=bound(moved, flops, rate), library_ms=lib_ms["gmm"]),
            "gmm_dlhs": dict(ms=time_ms(lambda: G._gmm_cuda(dout, rhs, tile_group,
                                                            transpose_rhs=True, **kw)),
                             plain_ms=time_ms(lambda: G._gmm_plain(df, rf, tile_group,
                                                                   transpose_rhs=True, **kw)),
                             bound=bound(moved, flops, rate), library_ms=lib_ms["gmm_dlhs"]),
            "tgmm": dict(max_abs_err=e_tgmm[0],
                         ms=time_ms(lambda: G._tgmm_cuda(lhs, dout, tile_group, e, **kw)),
                         plain_ms=time_ms(lambda: G._tgmm_plain(lf, df, tile_group, e, **kw)),
                         bound=bound(moved, flops, rate), library_ms=lib_ms["tgmm"]),
        }
        for name, r in res.items():
            lib_text = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
            print(f"time {name} [{tag}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
                  f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
                  f"{lib_text} (torch._grouped_mm)", flush=True)
        return res

    e = MOE_EXPERTS
    dst, tile_group, m = routed(MOE_TOKENS, e)
    check(m == 9216 and tile_group.numel() == 72, f"layout of 8192 pairs: m_pad {m}")
    main = case(f"gate/up m{m} k{MOE_D} n{MOE_F}", dst, tile_group, m, e, MOE_D, MOE_F,
                timed=True)
    case(f"down m{m} k{MOE_F} n{MOE_D}", dst, tile_group, m, e, MOE_F, MOE_D, timed=True)
    dst, tile_group, m = routed(MOE_TOKENS, e, skip=(3,))
    case(f"empty expert 3, m{m} k{MOE_D} n{MOE_F}", dst, tile_group, m, e, MOE_D, MOE_F,
         empty=(3,))
    one = torch.full((8,), 2, dtype=torch.int32, device="cuda")
    case("one expert owns every tile, m1024 k256 n384", None, one, 1024, e, 256, 384,
         empty=tuple(x for x in range(e) if x != 2))
    dst, tile_group, m = routed(300, 4)
    case(f"ragged widths m{m} k72 n200", dst, tile_group, m, 4, 72, 200)
    case(f"mixtral-tiny m{m} k64 n128", dst, tile_group, m, 4, 64, 128)
    case(f"mixtral-tiny down m{m} k128 n64", dst, tile_group, m, 4, 128, 64)
    case(f"float32 m{m} k72 n200", dst, tile_group, m, 4, 72, 200, dtype=torch.float32)
    dst, tile_group, m = routed(1024, e, skip=(0, 7))
    case(f"float32, empty experts 0 and 7, m{m} k256 n512", dst, tile_group, m, e, 256, 512,
         dtype=torch.float32, empty=(0, 7))
    dst, tile_group, m = routed(1024, e, block_m=256)
    case(f"block_m 256, m{m} k256 n384", dst, tile_group, m, e, 256, 384, block_m=256)
    # Ids past the last expert (never made by the layout) read as E - 1 in
    # K4 and in its plain version; K5's plain version takes no such id.
    past = torch.tensor([0, e, 3, e + 1, 100, e - 1, 2, e], dtype=torch.int32, device="cuda")
    case(f"tile ids {past.tolist()} over {e} experts, m1024 k256 n384", None, past, 1024, e,
         256, 384, k5=False)
    return {"gmm": main["gmm"], "tgmm": main["tgmm"]}


def phase_moe_dispatch(M, card):
    """One mixtral-small layer in float32: the "gmm" dispatch against the
    "ragged" oracle on the same weights and tokens (one layer, so both
    route the same tokens to the same experts)."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.llama import causal_lm_loss
    from ray_tpu_torch.models.mixtral import MixtralForCausalLM

    base = replace(M.CONFIGS["mixtral-small"], num_layers=1, dtype=torch.float32)
    ids = torch.randint(0, base.vocab_size, (1, 512), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    results = []
    for dispatch in ("gmm", "ragged"):
        model = MixtralForCausalLM(replace(base, moe_dispatch=dispatch), device="cuda")
        logits = model(ids)
        causal_lm_loss(logits, torch.roll(ids, -1, dims=1)).backward()
        results.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (lg, gg), (lr, gr) = results
    errs = [assert_close("MoE gmm logits", lg, lr, F32_TOL, F32_TOL, F32_TOL)]
    for name, g in gr.items():
        # Each gradient as one row: its normwise error over the whole tensor.
        # Element-wise, an entry that cancels to near zero keeps the error of
        # its terms, so the atol scales with the largest entry.
        errs.append(assert_close(f"MoE gmm grad {name}", gg[name].reshape(1, -1),
                                 g.reshape(1, -1), F32_TOL * float(g.abs().max()),
                                 F32_TOL, F32_TOL, tile=1))
    print(f"MoE dispatch [mixtral-small, 1 layer, b1 s512, float32]: gmm against ragged, "
          f"logits and {len(gr)} grads: {fmt(worst(*errs))}; limit rel {F32_TOL}: ok",
          flush=True)


def phase_mixtral(A, G, M, card, bench_model, peak):
    """The Mixtral path at full width and depth, counted from zero; returns
    its launches."""
    import torch
    from dataclasses import replace

    cfg = replace(M.CONFIGS["mixtral-small"], param_dtype=torch.bfloat16, moe_dispatch="gmm")
    model = M.MixtralForCausalLM(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    G.reset_launch_counts()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, peak, loss_fn=M.moe_lm_loss,
                    n_params=cfg.active_params_per_token())
    launches = {**A.LAUNCHES, **G.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"Mixtral loss not finite: {losses}")
    check(losses[-1] < losses[0], f"Mixtral loss did not fall: {losses}")
    steps, n = TIMED_STEPS + 1, cfg.num_layers
    # remat "dots" checkpoints each layer. Forward: K1 once, K4 three times
    # (gate, up, down). Backward of a layer: its recompute runs the forward
    # again up to the last tensor it saved, which comes after the down
    # projection, so K1 and K4 x3 again; then K2 and K3 once, and for each
    # of the three projections K4 (dlhs) and K5 (drhs). Per layer and step:
    # K1 2, K2 1, K3 1, K4 9, K5 3 (counted on the CPU by the tests too).
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm": 9 * n, "tgmm": 3 * n}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"Mixtral: {name} launched {launches[name]} times in {steps} steps, "
              f"expected {k * steps}")
    print(f"train mixtral-small (8 layers, 8 experts, top-2, gmm) b{BATCH} s{SEQ} bf16 on "
          f"{card}: losses {[round(x, 4) for x in losses]}, {r['tokens_per_s']:.1f} "
          f"tokens/s, step {r['step_ms']:.1f} ms, MFU over active params "
          f"{r['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)
    return launches


def phase_probe(M):
    """`resolve_moe_dispatch` on the card, its disk cache under a
    temporary HOME; prints the pick and both times."""
    import torch
    from dataclasses import replace

    cfg = replace(M.CONFIGS["mixtral-small"], param_dtype=torch.bfloat16)
    saved = {k: os.environ.get(k) for k in ("HOME", "RAY_TPU_MOE_DISPATCH")}
    with tempfile.TemporaryDirectory() as home:
        os.environ["HOME"] = home
        os.environ.pop("RAY_TPU_MOE_DISPATCH", None)
        M._RESOLVED.clear()
        try:
            pick = M.resolve_moe_dispatch(cfg, tokens=BATCH * SEQ)
            cached = os.path.exists(M._cache_path())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(cached, "resolve_moe_dispatch did not write its disk cache")
    (seconds,) = M.PROBE_SECONDS.values()
    print(f"dispatch probe [mixtral-small widths, {BATCH * SEQ} tokens, median of "
          f"{M.PROBE_REPEATS} rounds of 10 steps]: picks {pick}; capacity {seconds['capacity'] * 1e3:.3f} ms, gmm "
          f"{seconds['gmm'] * 1e3:.3f} ms per forward + backward (capacity wins only "
          f"below {1 - M.PROBE_MARGIN:g} of gmm)", flush=True)


def phase_long_kernels(A):
    """K1-K3 at the two shapes this slice adds: the long-context sweep's
    (llama-1b at batch 1, 16 heads of 128, T 8192-32768; held on a subset
    of heads where the plain versions' score matrices of every head would
    not fit, timed on all 16) and GPT's (gpt2-large at batch 4: 80 heads
    of 64, T 1024, plain multi-head attention)."""
    import torch

    case, _ = attention_cases(A, seed=3)
    for bh, t, held in LONG_ATTN:
        case(bh, t, t, 128, True, timed=True, check_bh=held)
        torch.cuda.empty_cache()
    case(**GPT_ATTN, timed=True)
    torch.cuda.empty_cache()


def phase_gpt(A, card, bench_model, peak):
    """GPT on the card: a 2-layer model at gpt2-large's widths against the
    same weights on the CPU's plain path (bf16 logits and loss), then
    gpt2-large at full width and depth trained from zero counts."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.gpt import CONFIGS as GPT_CONFIGS
    from ray_tpu_torch.models.gpt import GPTForCausalLM
    from ray_tpu_torch.models.llama import causal_lm_loss

    base = GPT_CONFIGS["gpt2-large"]
    small = replace(base, num_layers=2)
    ids = torch.randint(0, base.vocab_size, (1, 256),
                        generator=torch.Generator().manual_seed(4))
    targets = torch.roll(ids, -1, dims=1)
    on_card = GPTForCausalLM(small, device="cuda")
    on_cpu = GPTForCausalLM(small, device="cpu")
    on_cpu.load_state_dict(on_card.state_dict())
    with torch.no_grad():
        got = on_card(ids.cuda()).float().cpu()
        want = on_cpu(ids).float()
    loss_got, loss_want = (float(causal_lm_loss(x, targets)) for x in (got, want))
    rel = float((got - want).norm() / want.norm())
    check(bool(torch.isfinite(got).all()) and rel <= GPT_LOGITS_REL
          and abs(loss_got - loss_want) <= GPT_LOGITS_REL * abs(loss_want),
          f"GPT logits on the card vs the CPU: normwise {rel:.3e}, loss {loss_got} vs "
          f"{loss_want} (limit {GPT_LOGITS_REL})")
    print(f"GPT [gpt2-large widths, 2 layers, b1 s256, bf16]: logits on the card vs the "
          f"CPU plain path normwise {rel:.2e}, loss {loss_got:.5f} vs {loss_want:.5f}; "
          f"limit {GPT_LOGITS_REL}: ok", flush=True)
    del on_card, on_cpu
    torch.cuda.empty_cache()

    model = GPTForCausalLM(base, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    r = bench_model(model, GPT_BATCH, GPT_SEQ, TIMED_STEPS, peak)
    launches = dict(A.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"GPT loss not finite: {losses}")
    check(losses[-1] < losses[0], f"GPT loss did not fall: {losses}")
    steps, n = TIMED_STEPS + 1, base.num_layers
    # remat: K1 in each block's forward and again in its recompute; K2
    # and K3 once per block in backward.
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"GPT: {name} launched {launches[name]} times in {steps} steps, "
              f"expected {k * steps}")
    print(f"train gpt2-large (36 layers, 20 heads of 64, f32 params, bf16 compute, remat) "
          f"b{GPT_BATCH} s{GPT_SEQ} on {card}: losses {[round(x, 4) for x in losses]}, "
          f"{r['tokens_per_s']:.1f} tokens/s, step {r['step_ms']:.1f} ms, MFU "
          f"{r['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)


def phase_longctx(A, card, peak):
    """The bench's long-context sweep (`ray_tpu_torch.bench.longctx_sweep`)
    as `python -m ray_tpu_torch.bench` runs it: llama-1b, bf16
    parameters, batch 1, T 8192, 16384 and 32768, 5 timed steps each with
    the chunked loss; a later point may be recorded as out of memory."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.bench import LONGCTX_SEQS, longctx_sweep
    from ray_tpu_torch.models.llama import CONFIGS

    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    seqs = [int(x) for x in LONGCTX_SEQS.split(",")]
    A.reset_launch_counts()
    out = longctx_sweep(cfg, LONGCTX_BENCH_STEPS, peak, torch.device("cuda"), seqs)
    launches = dict(A.LAUNCHES)
    points = out["longctx"]
    ran = [p for p in points if "oom" not in p]
    check(len(points) == len(seqs) or "oom" in points[-1],
          f"long-context sweep stopped early without an OOM: {points}")
    for p in points:
        if "oom" in p:
            print(f"longctx llama-1b b1 s{p['seq']} on {card}: {p['oom']} (recorded; "
                  "the sweep ends here)", flush=True)
            continue
        check(math.isfinite(p["loss"]), f"long-context loss not finite: {p}")
        print(f"longctx llama-1b b1 s{p['seq']} bf16 on {card}: loss {p['loss']:.4f}, "
              f"{p['tokens_per_s']:.1f} tokens/s, step {p['step_ms']:.1f} ms, MFU "
              f"{p['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory "
              f"{p['peak_memory_gb']:.2f} GB", flush=True)
    check(out["longctx_seq"] == seqs[0] and out["longctx_mfu"] == ran[0]["mfu"],
          f"long-context headline is not the first point's: {out}")
    # remat "nothing": per layer and step K1 twice, K2 and K3 once; a
    # point that ran out of memory launched some before it stopped.
    steps, n = max(5, LONGCTX_BENCH_STEPS // 2) + 1, cfg.num_layers
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    for name, k in per_step.items():
        want = k * steps * len(ran)
        ok = launches[name] == want if len(ran) == len(points) else launches[name] >= want
        check(ok, f"long-context sweep: {name} launched {launches[name]} times, expected "
                  f"{want} over {len(ran)} points of {steps} steps")
    print(f"longctx sweep: {len(ran)} points measured, headline s{out['longctx_seq']} "
          f"MFU {out['longctx_mfu']:.4f}; launches {launches}", flush=True)


def phase_ring_blocks(A):
    """K1-K3 as the ring runs them on one rank: a block without the causal
    mask at T 8192, held and timed as in phase 10;
    then the diagonal block (causal) and an earlier block of the same
    queries, merged as `ring_attention` merges them, against the plain
    attention over both blocks' keys, and K2 + K3 on each block given the
    merged (global) o and lse, against their plain versions on the same
    inputs. The plain versions are held on HELD heads, where their float32
    scores over both blocks fit beside the kernels' inputs."""
    import torch

    from ray_tpu_torch.ops.ring_attention import _merge

    case, rand = attention_cases(A, seed=5)
    bh, t, d, held = RING_HEADS, RING_SEQ // RING_RANKS, RING_D, 4
    case(bh, t, t, d, False, timed=True)
    torch.cuda.empty_cache()

    q, do = rand(bh, t, d), rand(bh, t, d)
    (k_diag, v_diag), (k_prev, v_prev) = (rand(bh, t, d), rand(bh, t, d)), \
        (rand(bh, t, d), rand(bh, t, d))
    scale = 1.0 / math.sqrt(d)
    o_d, lse_d = A._flash_fwd_cuda(q, k_diag, v_diag, causal=True, sm_scale=scale)
    o_p, lse_p = A._flash_fwd_cuda(q, k_prev, v_prev, causal=False, sm_scale=scale)
    o, lse = _merge(o_d, lse_d, o_p, lse_p)
    o = o.to(q.dtype)
    # The plain attention over [earlier block, diagonal block]: the
    # end-aligned causal mask lets each query see the whole earlier block
    # and the diagonal block up to itself.
    f = [x[:held].float() for x in (q, k_prev, k_diag, v_prev, v_diag, do)]
    qf, kpf, kdf, vpf, vdf, dof = f
    o_ref, lse_ref = A._flash_fwd_plain(qf, torch.cat([kpf, kdf], 1), torch.cat([vpf, vdf], 1),
                                        causal=True, sm_scale=scale)
    errs = [assert_close("ring merge o", o[:held], o_ref, O_TOL, O_TOL, REL_TOL),
            assert_close("ring merge lse", lse[:held], lse_ref, LSE_ATOL, 0.0)]
    # K2 and K3 take the plain merged lse and delta on the held heads
    # (the merged kernels' elsewhere), so each block is held on identical
    # inputs; over a block a row's p sums to less than 1.
    delta_ref = (dof * o_ref).sum(-1)
    lse_in = torch.cat([lse_ref, lse[held:]])
    delta = torch.cat([delta_ref, (do[held:].float() * o[held:].float()).sum(-1)])
    blocks = (("diagonal", k_diag, v_diag, kdf, vdf, True),
              ("earlier", k_prev, v_prev, kpf, vpf, False))
    for name, k, v, kf, vf, causal in blocks:
        kw = dict(causal=causal, sm_scale=scale)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        dk_p, dv_p = A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_ref, delta_ref, **kw)
        dq_p = A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_ref, delta_ref, **kw)
        torch.cuda.synchronize()
        errs += [assert_close(f"ring {name} block K2 dk", dk[:held], dk_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL),
                 assert_close(f"ring {name} block K2 dv", dv[:held], dv_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL),
                 assert_close(f"ring {name} block K3 dq", dq[:held], dq_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL)]
        del dk, dv, dq, dk_p, dv_p, dq_p
    print(f"ring blocks [bh{bh} t{t} d{d}, two blocks merged, held on {held} heads]: merged o "
          f"and lse against the plain attention over both blocks, K2 and K3 given the "
          f"global (o, lse) on each block: {fmt(worst(*errs))}; limit rel {REL_TOL}: ok",
          flush=True)
    torch.cuda.empty_cache()


def phase_ring(A, card):
    """Ring attention and the sequence-parallel llama-1b step over
    RING_RANKS processes sharing the card, through `parallel.launch`."""
    import functools
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, chunked_causal_lm_loss
    from ray_tpu_torch.parallel.launch import ring_inputs, run_llama_train, run_ring, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    n, t, h, d = RING_RANKS, RING_SEQ, RING_HEADS, RING_D
    spec = MeshSpec(seq=n)
    # (a) ring attention against single-card flash_attention on the same tensors
    inputs = (6, 1, h, h, t, d)
    q, k, v, do = (torch.from_numpy(x).to("cuda", torch.bfloat16) for x in ring_inputs(*inputs))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = A.flash_attention(*leaves, causal=True)
    o.backward(do)
    want = {name: x.detach().cpu() for name, x in
            zip(("o", "dq", "dk", "dv"), (o, *(x.grad for x in leaves)))}
    del q, k, v, do, leaves, o
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(run_ring, n, spec, [dict(inputs=inputs, causal=True, dtype="bfloat16")],
                deadline_s=300)
    seconds = time.perf_counter() - t0
    parts = sorted((r[0] for r in res), key=lambda r: r["seq_rank"])
    for r in parts:
        print(f"ring rank {r['seq_rank']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}); launches {r['launches']}", flush=True)
    errs = []
    for name in ("o", "dq", "dk", "dv"):
        got = torch.cat([r[name] for r in parts], dim=2).float()
        tol = O_TOL if name == "o" else GRAD_TOL
        errs.append(assert_close(f"ring {name} vs single-card", got, want[name].float(), tol, tol,
                                 REL_TOL))
    launches = {name: sum(r["launches"][name] for r in parts) for name in A.LAUNCHES}
    blocks = n * (n + 1) // 2  # rank r runs r + 1 blocks
    check(launches == {"flash_fwd": blocks, "flash_bwd_dkv": blocks, "flash_bwd_dq": blocks},
          f"ring launches {launches}, expected {blocks} of each")
    print(f"ring attention [{n} ranks on one card, b1 h{h} T {t} (shards of {t // n}) d{d} "
          f"bf16 causal]: o, dq, dk, dv against single-card flash_attention {fmt(worst(*errs))}; "
          f"limit rel {REL_TOL}; launches over the ranks {launches}; world of {n} "
          f"processes in {seconds:.1f} s: ok", flush=True)
    del want

    # (b) the sequence-parallel llama-1b train steps against the same
    # steps on one card, from the same weights and ids
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, t))
    loss_fn = functools.partial(chunked_causal_lm_loss, chunk_size=RING_CHUNK)
    model = LlamaForCausalLM(cfg, device="cuda")
    optimizer = make_optimizer(model)
    ids_c = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    targets_c = torch.roll(ids_c, -1, 1)
    single, single_s = timed_steps(
        lambda: train_step(model, optimizer, ids_c, targets_c, loss_fn), RING_TIMED_STEPS)
    del model, optimizer, ids_c, targets_c
    torch.cuda.empty_cache()
    res = spawn(run_llama_train, n, spec, cfg, ids, RING_TIMED_STEPS, loss_fn, deadline_s=600)
    losses = res[0]["losses"]
    digests = [r["param_digest"] for r in res]
    check(all(x == digests[0] for x in digests),
          f"ranks hold different parameters after the steps: digests {digests}")
    check(all(math.isfinite(x) for x in losses), f"sequence-parallel loss not finite: {losses}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    check(max(loss_rel) <= RING_LOSS_RTOL,
          f"sequence-parallel losses {losses} vs single-card {single}: relative "
          f"{loss_rel} (rtol {RING_LOSS_RTOL})")
    check(losses[-1] < losses[0], f"sequence-parallel loss did not fall: {losses}")
    launches = {name: sum(r["launches"][name] for r in res) for name in A.LAUNCHES}
    steps, layers = RING_TIMED_STEPS + 1, cfg.num_layers
    # remat "nothing": each layer's ring forward runs twice (forward and
    # recompute), its backward once; each pass launches `blocks` kernels
    # over the ranks.
    per_step = {"flash_fwd": 2 * layers * blocks, "flash_bwd_dkv": layers * blocks,
                "flash_bwd_dq": layers * blocks}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"sequence-parallel step: {name} launched {launches[name]} times over the ranks "
              f"in {steps} steps, expected {k * steps}")
    step_ms = max(r["step_ms"] for r in res)
    for r in sorted(res, key=lambda r: r["seq_rank"]):
        print(f"seq-parallel rank {r['seq_rank']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}), step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"train llama-1b seq-parallel (seq {n}, b1, T {t}, bf16, chunked loss) on {card}, "
          f"{n} ranks sharing the card over gloo through host memory: losses "
          f"{losses} against single-card {single} (relative {max(loss_rel):.2e}, rtol "
          f"{RING_LOSS_RTOL}), parameters equal on every rank, step {step_ms:.1f} ms "
          f"(slowest rank; one card alone {single_s / RING_TIMED_STEPS * 1e3:.1f} ms), "
          f"{t / step_ms * 1e3:.1f} "
          f"tokens/s, launches over the ranks {launches} ({per_step} per step): ok; not a "
          f"measure of scaling (one card, host-staged exchange)", flush=True)
    print("FSDP and tensor parallelism (parallel.mesh.shard_params) are not run: on one card "
          "gloo has no all-gather or reduce-scatter of CUDA tensors and NCCL refuses two "
          "ranks on a card; they run in the CPU tests over gloo", flush=True)


def _grad_rows(g):
    """A gradient as rows for `rel_errs`: [out, in] weights by output row
    (tiles of TILE), a vector as one row (tile 1)."""
    return (g.reshape(-1, g.shape[-1]), TILE) if g.dim() > 1 else (g.reshape(1, -1), 1)


def phase_pipeline(A, card):
    """llama-1b's decoder layers as a pipeline of PIPE_STAGES ranks sharing
    the card, against the same layers in sequence on one card."""
    import numpy as np
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.parallel.launch import run_pipeline_llama, sequential_llama, spawn

    s_count, layers, m_count = PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    check(s_count * layers == cfg.num_layers, "the pipeline must hold every layer")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (m_count, 1, SEQ))
    want = sequential_llama(cfg, s_count, layers, ids, TIMED_STEPS, PIPE_LR, device="cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sorted(spawn(run_pipeline_llama, s_count, cfg, layers, ids, TIMED_STEPS, PIPE_LR,
                       deadline_s=600), key=lambda r: r["stage"])
    seconds = time.perf_counter() - t0
    errs = []
    for r in res:
        errs.append(assert_close(f"pipeline y (stage {r['stage']}) vs sequential",
                                 r["y"].float(), want["y"].float(), O_TOL, O_TOL, REL_TOL))
        grads = want["grads"][r["stage"]]
        check(set(r["grads"]) == set(grads), f"stage {r['stage']}: other parameters")
        for name, w in grads.items():
            (got, tile), (ref, _) = _grad_rows(r["grads"][name].float()), _grad_rows(w.float())
            errs.append(assert_close(f"pipeline grad {name} (stage {r['stage']})", got, ref,
                                     GRAD_TOL * float(ref.abs().max()), GRAD_TOL, REL_TOL,
                                     tile=tile))
    steps = TIMED_STEPS + 1
    for r in res:
        losses = r["losses"]
        check(all(math.isfinite(x) for x in losses), f"pipeline loss not finite: {losses}")
        check(losses[-1] < losses[0], f"pipeline loss did not fall: {losses}")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
        check(max(loss_rel) <= RING_LOSS_RTOL,
              f"pipeline losses {losses} vs sequential {want['losses']}: relative {loss_rel} "
              f"(rtol {RING_LOSS_RTOL})")
        # Each rank runs its 11 layers on the M microbatches of its own
        # ticks only: K1 in the forward and again in remat "nothing"'s
        # recompute inside the backward's VJP, K2 and K3 once.
        per_step = {"flash_fwd": 2 * m_count * layers, "flash_bwd_dkv": m_count * layers,
                    "flash_bwd_dq": m_count * layers}
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"pipeline stage {r['stage']}: {name} launched {r['launches'][name]} times "
                  f"in {steps} steps, expected {k * steps}")
        print(f"pipeline stage {r['stage']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}), step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB, launches {r['launches']}", flush=True)
    step_ms = max(r["step_ms"] for r in res)
    print(f"pipeline llama-1b (22 layers as {s_count} stages of {layers}, {m_count} "
          f"microbatches of b1 s{SEQ}, bf16, SGD {PIPE_LR} on mean(y^2)) on {card}, "
          f"{s_count} ranks sharing the card over gloo through host memory: y and "
          f"{sum(len(g) for g in want['grads'])} grads against the layers in sequence "
          f"{fmt(worst(*errs))}, limit rel {REL_TOL}; losses {res[0]['losses']} against "
          f"{want['losses']} (rtol {RING_LOSS_RTOL}); step {step_ms:.1f} ms (slowest rank; "
          f"one card in sequence {want['step_ms']:.1f} ms), peak memory per rank "
          f"{[round(r['peak_memory_gb'], 2) for r in res]} GB; bubble share "
          f"(S-1)/(M+S-1) = {(s_count - 1) / (m_count + s_count - 1):.2f} (the schedule's, "
          f"not measured); launches per rank {per_step} per step; world in {seconds:.1f} s: "
          f"ok; not a measure of scaling (one card, host-staged exchange)", flush=True)


def phase_expert(A, card):
    """mixtral-small on data x expert over ranks sharing the card, against
    the same steps on one card with "capacity"."""
    import numpy as np
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.mixtral import CONFIGS, MixtralForCausalLM, moe_lm_loss
    from ray_tpu_torch.parallel.launch import run_mixtral_train, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    spec = MeshSpec(data=EXPERT_DATA, expert=EXPERT_EP)
    cfg = replace(CONFIGS["mixtral-small"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, SEQ))
    model = MixtralForCausalLM(replace(cfg, moe_dispatch="capacity"), device="cuda")
    optimizer = make_optimizer(model)
    ids_c = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    targets_c = torch.roll(ids_c, -1, 1)
    single, single_s = timed_steps(
        lambda: train_step(model, optimizer, ids_c, targets_c, moe_lm_loss), TIMED_STEPS)
    del model, optimizer, ids_c, targets_c
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(run_mixtral_train, spec.num_devices, spec, cfg, ids, TIMED_STEPS,
                deadline_s=900)
    seconds = time.perf_counter() - t0
    losses = res[0]["losses"]
    check(all(r["losses"] == losses for r in res), "ranks report different losses")
    check(all(math.isfinite(x) for x in losses), f"expert-parallel loss not finite: {losses}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    check(max(loss_rel) <= RING_LOSS_RTOL,
          f"expert-parallel losses {losses} vs single-card {single}: relative {loss_rel} "
          f"(rtol {RING_LOSS_RTOL})")
    check(losses[-1] < losses[0], f"expert-parallel loss did not fall: {losses}")
    for r in res:
        pair = [p["param_digest"] for p in res if p["expert_rank"] == r["expert_rank"]]
        check(all(d == r["param_digest"] for d in pair),
              f"the ranks of expert {r['expert_rank']}'s data pair differ: {pair}")
        check(r["replicated_digest"] == res[0]["replicated_digest"],
              "the parameters that are not experts differ between ranks")
    launches = {name: sum(r["launches"][name] for r in res) for name in A.LAUNCHES}
    steps, layers = TIMED_STEPS + 1, cfg.num_layers
    # Each rank runs every layer's attention on its data replica's row:
    # under remat "dots" K1 in the forward and again in the recompute, K2
    # and K3 once.
    ranks = spec.num_devices
    per_step = {"flash_fwd": 2 * layers * ranks, "flash_bwd_dkv": layers * ranks,
                "flash_bwd_dq": layers * ranks}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"expert-parallel step: {name} launched {launches[name]} times over the ranks "
              f"in {steps} steps, expected {k * steps}")
    step_ms = max(r["step_ms"] for r in res)
    for r in sorted(res, key=lambda r: (r["data_rank"], r["expert_rank"])):
        print(f"expert rank {r['expert_rank']} of data replica {r['data_rank']}: backend "
              f"{r['backend']}, {r['device']} ({r['card']}), step {r['step_ms']:.1f} ms, peak "
              f"memory {r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"train mixtral-small expert-parallel (data {EXPERT_DATA} x expert {EXPERT_EP}, "
          f"{cfg.num_experts // EXPERT_EP} experts a rank, b{BATCH} s{SEQ}, bf16, remat dots, "
          f"capacity) on {card}, {ranks} ranks sharing the card over gloo through host "
          f"memory: losses {losses} against single-card capacity {single} (relative "
          f"{max(loss_rel):.2e}, rtol {RING_LOSS_RTOL}), data pairs equal, replicated "
          f"parameters equal on every rank, step {step_ms:.1f} ms (slowest rank; one card "
          f"alone {single_s / TIMED_STEPS * 1e3:.1f} ms), launches over the ranks {launches} "
          f"({per_step} per step); world in {seconds:.1f} s: ok; not a measure of scaling "
          f"(one card, host-staged exchange)", flush=True)
    print("the dense four-axis dryrun (ray_tpu_torch.dryrun: data x fsdp x seq x tensor) and "
          "dryrun_multichip are not run: on one card gloo has no all-gather or reduce-scatter "
          "of CUDA tensors and NCCL refuses two ranks on a card; both run in the CPU tests "
          "over gloo", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ray_tpu_torch._device import card_description
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import (
        CONFIGS, LlamaForCausalLM, causal_lm_loss, chunked_causal_lm_loss,
    )
    from ray_tpu_torch.models import mixtral as M
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import gmm as G

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_description()
    check(card is not None, "nvidia-smi did not report the card")
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    report_build(_build)

    # 3. attention kernels
    numbers = phase_kernels(A)
    # 4. grouped-matmul kernels
    numbers.update(phase_gmm(G))
    torch.cuda.empty_cache()

    # 5. Llama train: the Llama path, counted from zero
    from dataclasses import replace

    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    A.reset_launch_counts()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    launches = dict(A.LAUNCHES)
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steps = TIMED_STEPS + 1
    # remat "nothing": K1 runs in each layer's forward and again in its
    # recompute; K2 and K3 once per layer in backward.
    per_step = {"flash_fwd": 2 * cfg.num_layers, "flash_bwd_dkv": cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers}
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{name} launched {launches[name]} times in {steps} steps, "
              f"expected {n * steps}")
    print(f"train llama-1b b{BATCH} s{SEQ} bf16 on {card}: losses "
          f"{[round(x, 4) for x in losses]}, {r['tokens_per_s']:.1f} tokens/s, "
          f"step {r['step_ms']:.1f} ms, MFU {r['mfu']:.4f} of "
          f"{H100_BF16_PEAK_FLOPS:.3g} FLOP/s; launches {launches}", flush=True)

    # 6. chunked loss
    import numpy as np

    ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (BATCH, SEQ)),
                          dtype=torch.long, device="cuda")
    targets = torch.roll(ids, -1, dims=1)
    with torch.no_grad():
        full = float(causal_lm_loss(model(ids), targets))
        chunked = float(chunked_causal_lm_loss(model, ids, targets, chunk_size=1024))
    rel = abs(chunked - full) / abs(full)
    check(math.isfinite(full) and rel < CHUNKED_LOSS_RTOL,
          f"chunked loss {chunked} vs full {full} (rel {rel:.2e})")
    print(f"chunked loss: {chunked:.6f} vs full {full:.6f} (rel {rel:.2e}): ok",
          flush=True)
    del model
    torch.cuda.empty_cache()

    # 7. MoE dispatch: gmm against the ragged oracle
    phase_moe_dispatch(M, card)
    torch.cuda.empty_cache()

    # 8. Mixtral train: the Mixtral path, counted from zero
    moe_launches = phase_mixtral(A, G, M, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()

    # 9. dispatch probe
    phase_probe(M)
    torch.cuda.empty_cache()

    # 10. attention kernels at the long-context and GPT shapes
    phase_long_kernels(A)
    # 11. GPT: parity on a small input, then the gpt2-large path counted from zero
    phase_gpt(A, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    # 12. the long-context sweep, counted from zero
    phase_longctx(A, card, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    # 13. ring blocks in one process
    phase_ring_blocks(A)
    # 14. the ring over RING_RANKS processes on the card, counted in each rank
    phase_ring(A, card)
    torch.cuda.empty_cache()
    # 15. the pipeline over PIPE_STAGES processes, counted in each rank
    phase_pipeline(A, card)
    torch.cuda.empty_cache()
    # 16. expert parallelism over data x expert processes, counted in each rank
    phase_expert(A, card)

    # Each kernel's launches on its own path: K1-K3 on the Llama path, K4
    # and K5 on the Mixtral path.
    launches.update({name: moe_launches[name] for name in ("gmm", "tgmm")})
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        n = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": n["max_abs_err"],
            "ms": n["ms"], "plain_ms": n["plain_ms"], "bound_ms": n["bound"][0],
            "bound_by": n["bound"][1], "library_ms": n["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
