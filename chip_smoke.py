#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: the card's name and power limit;
2. build: every kernel source in `ray_tpu_torch/ops/csrc/`, in parallel;
   the registers, spills and shared memory of the flash backward's
   kernels, from ptxas; the bf16 (Hopper) K2 and K3 must not spill;
3. attention kernels: K1 (forward), K2 (dK, dV) and K3 (dQ) against their
   plain PyTorch versions, which run in float32 on the same bf16-rounded
   inputs, at the Llama path's shape (D 128), the Mixtral path's (D 64,
   and its GQA of 16 heads over 8) and at ragged, non-causal, float32,
   GQA and bf16 edge cases (D 72 and 96 on zero-filled columns, ragged
   Tq < Tk, one tile), element-wise and by normwise relative error per
   tile; K2 and K3 give bitwise-equal outputs over two launches; times at
   both paths' shapes of each kernel, its plain version and a library
   call as a yardstick the port never calls:
   `scaled_dot_product_attention` for K1, PyTorch's flash-attention
   backward for the K2 + K3 pair;
4. grouped-matmul kernels: K4 (gmm, and its dlhs form on transposed
   expert matrices) and K5 (tgmm) against their plain versions at the
   Mixtral path's shapes, from a real top-2 layout of 4096 tokens over 8
   experts, and at an empty expert (K5 writes zeros), one expert owning
   every tile, K and N off the kernel's tile, mixtral-tiny's widths and
   float32; times of each, its plain version and `torch._grouped_mm` as
   the yardstick;
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
   checked.

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


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    report; a kernel of namespace `flash` is named as in its source, with
    its template argument (`dkv_sm90<128>`)."""
    import re

    found, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            m = re.match(r"_ZN5flash(\d+)(\w+)", name)
            if m:
                n, rest = int(m.group(1)), m.group(2)
                t = re.match(r"ILi(\d+)E", rest[n:])
                name = rest[:n] + (f"<{t.group(1)}>" if t else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append((name, int(m.group(1)), spill))
    return found


def report_flash_bwd_build(build) -> None:
    """Prints the flash backward kernels' registers, spills and (bf16)
    shared memory per block; fails if a bf16 kernel spills."""
    import ctypes

    smem = build.library("flash_bwd").flash_bwd_sm90_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    parts = []
    for name, regs, spill in ptxas_kernels(build.ptxas_report("flash_bwd")):
        text = f"{name} {regs} registers, {spill} spill bytes"
        if "sm90" in name:
            check(spill == 0, f"ptxas: {name} spills {spill} bytes")
            width = int(name.split("<")[1].rstrip(">"))
            text += f", {smem(width, int(name.startswith('dq')))} bytes of shared memory"
        parts.append(text)
    check(sum("sm90" in p for p in parts) == 4, f"ptxas report of flash_bwd.cu: {parts}")
    print("ptxas flash_bwd.cu: " + "; ".join(parts), flush=True)


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


def phase_kernels(A):
    """Holds K1-K3 against their plain versions; returns each kernel's
    numbers at the main path's shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(bh, tq, tk, d, causal, dtype=torch.bfloat16, timed=False):
        tag = f"bh{bh} tq{tq} tk{tk} d{d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
        q, k, v, do = rand(bh, tq, d, dtype=dtype), rand(bh, tk, d, dtype=dtype), \
            rand(bh, tk, d, dtype=dtype), rand(bh, tq, d, dtype=dtype)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
        f32 = dtype == torch.float32
        o_tol = F32_TOL if f32 else O_TOL
        g_tol = F32_TOL if f32 else GRAD_TOL
        lse_tol = F32_TOL if f32 else LSE_ATOL
        rel = F32_TOL if f32 else REL_TOL

        o, lse = A._flash_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = A._flash_fwd_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        e_fwd = worst(assert_close(f"K1 o [{tag}]", o, o_p, o_tol, o_tol, rel),
                      assert_close(f"K1 lse [{tag}]", lse, lse_p, lse_tol, 0.0))
        # The backward kernels take the plain forward's lse and delta, so
        # each is held against its plain version on identical inputs.
        delta = (dof * o_p).sum(-1)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, **kw)
        dk_p, dv_p = A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta, **kw)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, **kw)
        dq_p = A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta, **kw)
        torch.cuda.synchronize()
        e_dkv = worst(assert_close(f"K2 dk [{tag}]", dk, dk_p, g_tol, g_tol, rel),
                      assert_close(f"K2 dv [{tag}]", dv, dv_p, g_tol, g_tol, rel))
        e_dq = assert_close(f"K3 dq [{tag}]", dq, dq_p, g_tol, g_tol, rel)
        print(f"kernels [{tag}]: K1 {fmt(e_fwd)}; K2 {fmt(e_dkv)}; "
              f"K3 {fmt(e_dq)}; limit rel {rel}: ok", flush=True)
        if not timed:
            return None
        # One writer per output: a second launch gives the same bits.
        dk2, dv2 = A._flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, **kw)
        dq2 = A._flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, **kw)
        same = all(torch.equal(x, y) for x, y in ((dk, dk2), (dv, dv2), (dq, dq2)))
        check(same, f"K2/K3 [{tag}]: two launches on the same inputs differ")
        print(f"deterministic [{tag}]: dk, dv and dq bitwise equal over two launches",
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
        # held to the plain version first so that it computes the same.
        lib_bwd = library_flash_bwd(q4, k4, v4, do4, causal, kw["sm_scale"])
        for name, got, want in zip(("dq", "dk", "dv"), lib_bwd(), (dq_p, dk_p, dv_p)):
            assert_close(f"library {name} [{tag}]", got.view(bh, -1, d), want,
                         g_tol, g_tol, rel)
        pair_lib_ms = time_ms(lib_bwd)
        res["flash_bwd_dkv"] = dict(
            max_abs_err=e_dkv[0],
            ms=time_ms(lambda: A._flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta, **kw)),
            bound=bound(2 * qb + 4 * kb + 2 * rows, 8 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        res["flash_bwd_dq"] = dict(
            max_abs_err=e_dq[0],
            ms=time_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta, **kw)),
            bound=bound(3 * qb + 2 * kb + 2 * rows, 6 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        for name, r in res.items():
            lib = "" if name == "flash_fwd" else " for dq, dk and dv together"
            print(f"time {name} [{tag}]: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}), library {r['library_ms']:.3f} ms{lib}",
                  flush=True)
        pair = res["flash_bwd_dkv"]["ms"] + res["flash_bwd_dq"]["ms"]
        print(f"time K2 + K3 [{tag}]: {pair:.3f} ms, library {pair_lib_ms:.3f} ms "
              f"(dq, dk and dv in one call)", flush=True)
        return res

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
    # bf16 edges of the Hopper K2 and K3: the 128-wide instance on
    # zero-filled columns, ragged Tq < Tk under the causal mask, one block.
    case(4, 1000, 1100, 72, True)
    case(4, 1000, 1100, 96, True)
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

    def routed(tokens, experts, skip=()):
        """(dst, tile_group, m) of a top-2 layout of random router logits,
        with the experts in `skip` never chosen."""
        logits = torch.randn(tokens, experts, generator=gen, device="cuda")
        logits[:, list(skip)] = -math.inf
        e_flat = logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1)
        _, dst, tile_group, m = G.aligned_group_layout(e_flat, experts)
        return dst, tile_group, m

    def case(tag, dst, tile_group, m, e, k, n, dtype=torch.bfloat16, timed=False, empty=()):
        """K4 (lhs [m, k] @ rhs [e, k, n]), its dlhs form (dout [m, n] @
        rhs^T) and K5 (lhs^T dout per expert). Rows outside `dst` are the
        layout's zero rows, as the model fills them (all rows where dst is
        None)."""
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
        kw = dict(block_m=128)

        def close(name, got, want, per_expert=False):
            atol = tol * float(want.pow(2).mean().sqrt())
            if per_expert:  # [E, K, N] as E rows, one tile each
                return assert_close(name, got.view(1, e, -1), want.view(1, e, -1), atol, tol,
                                    rel, tile=1)
            return assert_close(name, got, want, atol, tol, rel, tile=GMM_TILE)

        out = G._gmm_cuda(lhs, rhs, tile_group, **kw)
        dlhs = G._gmm_cuda(dout, rhs, tile_group, transpose_rhs=True, **kw)
        drhs = G._tgmm_cuda(lhs, dout, tile_group, e, **kw)
        torch.cuda.synchronize()
        want = G._gmm_plain(lf, rf, tile_group, **kw)
        want_t = G._gmm_plain(df, rf, tile_group, transpose_rhs=True, **kw)
        want_d = G._tgmm_plain(lf, df, tile_group, e, **kw)
        e_gmm = worst(close(f"K4 [{tag}]", out, want),
                      close(f"K4 dlhs [{tag}]", dlhs, want_t))
        e_tgmm = close(f"K5 [{tag}]", drhs, want_d, per_expert=True)
        for x in empty:
            check(bool((drhs[x] == 0).all()), f"K5 [{tag}]: expert {x} has no tiles, "
                                              f"but its drhs is not all zeros")
        print(f"gmm kernels [{tag}]: K4 {fmt(e_gmm)}; K5 {fmt(e_tgmm)}; "
              f"limit rel {rel}{'; empty experts ' + str(list(empty)) + ' zero' if empty else ''}"
              f": ok", flush=True)
        if not timed:
            return None

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
    report_flash_bwd_build(_build)

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
