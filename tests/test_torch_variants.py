"""Designs of the bf16 K1 and K5 that were measured and not taken
(`tests/csrc/kernel_variants.cu`), against the kernels as built, on the
card.

Each variant must give bitwise the output of the built kernel: K1's
overlap runs the same arithmetic in the same order, and K5's and K4's
variants change the order of the blocks, the pipelining or the tile
shape, never the order of a sum. The one exception is the WMMA kernel
that the bf16 K4 replaced, timed beside it: it sums in steps of 32 of K
on 16 x 16 fragments, another order, so it is held to the plain version
within `chip_smoke.py`'s limits instead. Their times, alternated with the built kernel's in
one process at the main path's shapes, are printed; `PERF.md` records
them. The tests need a CUDA card and `nvcc`, so they skip elsewhere. On
the card:

    python -m pytest --noconftest -q -s tests/test_torch_variants.py
"""
import ctypes
import subprocess
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as A
from ray_tpu_torch.ops import gmm as G

SOURCE = Path(__file__).resolve().parent / "csrc" / "kernel_variants.cu"
REPEATS, ITERS = 3, 50
K5_VARIANTS = ("simple grid (experts in id order)", "products in flight",
               "products in flight, 4 stages", "256 x 128 tile, 4 stages, products in flight")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the variants are Hopper kernels")
    out = tmp_path_factory.mktemp("variants") / "libkernel_variants.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(SOURCE)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fwd_overlap.argtypes = lib.fwd_pair.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float, i]
    lib.tgmm_variant.argtypes = [p] * 4 + [i] * 6
    lib.gmm_variant.argtypes = [p] * 4 + [i] * 7
    lib.fwd_overlap.restype = lib.fwd_pair.restype = i
    lib.tgmm_variant.restype = lib.gmm_variant.restype = i
    return lib


def _fastest_ms(fns):
    """{name: least device ms per call over REPEATS runs of ITERS calls},
    the runs alternating their order; timed as chip_smoke.py times."""
    import chip_smoke

    times = {name: [] for name in fns}
    for r in range(REPEATS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(chip_smoke.time_ms(fns[name], ITERS))
    return {name: min(ms) for name, ms in times.items()}


K1_VARIANTS = {"fwd_overlap": "next s product before the softmax",
               "fwd_pair": "128-row q tile on 2 warpgroups"}


@pytest.mark.cuda
@pytest.mark.parametrize("d,bh,tq,tk,causal", [
    (128, 32, 2048, 2048, True), (64, 32, 2048, 2048, True),  # the main paths, timed
    (128, 4, 777, 1000, True), (64, 8, 777, 1024, False)])    # ragged tails
def test_k1_variants_match_the_built_kernel(lib, d, bh, tq, tk, causal):
    gen = torch.Generator(device="cuda").manual_seed(d + tq)
    scale = d ** -0.5
    q = torch.randn(bh, tq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(bh, tk, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = A._flash_fwd_cuda(q, k, v, causal=causal, sm_scale=scale)
    fns = {"built": lambda: A._flash_fwd_cuda(q, k, v, causal=causal, sm_scale=scale)}
    for symbol, name in K1_VARIANTS.items():
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)

        def run(fn=getattr(lib, symbol), o2=o2, lse2=lse2):
            assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), lse2.data_ptr(),
                      bh, tq, tk, d, scale, int(causal)) == 0

        run()
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2), name
        fns[name] = run
    if tq != tk:
        return
    ms = _fastest_ms(fns)
    print(f"K1 variants [bh{bh} t{tq} d{d} causal bf16, least of {REPEATS} runs of {ITERS}]: "
          + "; ".join(f"{name} {t:.4f} ms" for name, t in ms.items()))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 3584), (3584, 1024)])
def test_k5_variants_match_the_built_kernel(lib, k, n):
    gen = torch.Generator(device="cuda").manual_seed(1)
    experts = 8
    e_flat = torch.randn(4096, experts, generator=gen, device="cuda").topk(2, dim=-1).indices
    _, dst, tile_group, m = G.aligned_group_layout(e_flat.reshape(-1), experts)
    lhs = torch.zeros((m, k), dtype=torch.bfloat16, device="cuda")
    dout = torch.zeros((m, n), dtype=torch.bfloat16, device="cuda")
    lhs[dst] = torch.randn(dst.numel(), k, generator=gen, device="cuda").to(torch.bfloat16)
    dout[dst] = torch.randn(dst.numel(), n, generator=gen, device="cuda").to(torch.bfloat16)
    built = G._tgmm_cuda(lhs, dout, tile_group, experts, block_m=128)
    fns = {"built": lambda: G._tgmm_cuda(lhs, dout, tile_group, experts, block_m=128)}
    for variant, name in enumerate(K5_VARIANTS):
        out = torch.empty_like(built)

        def run(variant=variant, out=out):
            assert lib.tgmm_variant(lhs.data_ptr(), dout.data_ptr(), tile_group.data_ptr(),
                                    out.data_ptr(), m, k, n, experts, 128, variant) == 0

        run()
        torch.cuda.synchronize()
        assert torch.equal(out, built), name
        fns[name] = run
    ms = _fastest_ms(fns)
    print(f"K5 variants [m{m} k{k} n{n} bf16, least of {REPEATS} runs of {ITERS}]: "
          + "; ".join(f"{name} {t:.4f} ms" for name, t in ms.items()))


K4_VARIANTS = ("128 x 256 tile, 4 stages", "blocks in groups of 8 m tiles",
               "WMMA kernel it replaced")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,transpose", [
    (1024, 3584, False), (3584, 1024, False),  # the main path's gate/up and down, timed
    (1024, 3584, True), (3584, 1024, True),    # their dlhs forms, timed
    (72, 200, False), (72, 200, True)])        # ragged widths
def test_k4_variants_match_the_built_kernel(lib, k, n, transpose):
    """rhs [E, k, n]; the forward multiplies lhs [M, k] by it, the dlhs
    form dout [M, n] by its transpose."""
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(2)
    experts, tokens = (8, 4096) if k > 72 else (4, 300)
    e_flat = torch.randn(tokens, experts, generator=gen, device="cuda").topk(2, dim=-1).indices
    _, dst, tile_group, m = G.aligned_group_layout(e_flat.reshape(-1), experts)
    width = n if transpose else k
    lhs = torch.zeros((m, width), dtype=torch.bfloat16, device="cuda")
    lhs[dst] = torch.randn(dst.numel(), width, generator=gen, device="cuda").to(torch.bfloat16)
    rhs = (torch.randn(experts, k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    kw = dict(block_m=128, transpose_rhs=transpose)
    built = G._gmm_cuda(lhs, rhs, tile_group, **kw)
    plain = G._gmm_plain(lhs.float(), rhs.float(), tile_group, **kw)
    fns = {"built": lambda: G._gmm_cuda(lhs, rhs, tile_group, **kw)}
    for variant, name in enumerate(K4_VARIANTS):
        out = torch.empty_like(built)

        def run(variant=variant, out=out):
            assert lib.gmm_variant(lhs.data_ptr(), rhs.data_ptr(), tile_group.data_ptr(),
                                   out.data_ptr(), m, width, out.shape[1], experts, 128,
                                   int(transpose), variant) == 0

        run()
        torch.cuda.synchronize()
        if name == "WMMA kernel it replaced":  # another order of sums: the smoke's limits
            tol = chip_smoke.GMM_TOL
            chip_smoke.assert_close(name, out, plain, tol * float(plain.pow(2).mean().sqrt()),
                                    tol, chip_smoke.REL_TOL, tile=chip_smoke.GMM_TILE)
        else:
            assert torch.equal(out, built), name
        fns[name] = run
    if k == 72:
        return
    ms = _fastest_ms(fns)
    form = "dlhs" if transpose else "forward"
    print(f"K4 variants [{form}, m{m} k{width} n{built.shape[1]} bf16, least of {REPEATS} "
          f"runs of {ITERS}]: " + "; ".join(f"{name} {t:.4f} ms" for name, t in ms.items()))
