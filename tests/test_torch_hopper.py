"""The Hopper building blocks of the port's kernels (`ray_tpu_torch/ops/
csrc/hopper.cuh`) against `torch.matmul`, on the card.

Each probe (`tests/csrc/hopper_probe.cu`) is one block: TMA loads bf16
tiles with the 128-byte swizzle, `wgmma` multiplies them through shared
memory descriptors, and the accumulator is written out through the
layout `hopper.cuh` states. Mode 0 reads both operands K-major, mode 1
reads B MN-major (the transpose bit), and mode 2 feeds the bf16-rounded
accumulator of a mode-0 product as the register A operand of a second
product whose B is MN-major, N 64 or 128. A wrong swizzle, descriptor or
fragment layout moves whole rows or columns; float32 sums of exact bf16
products agree with a float64 matmul to about 1e-5.

The tests need a CUDA card and `nvcc`, so they skip elsewhere. On the
card (the repository's root conftest imports JAX, which that machine
does not have):

    python -m pytest --noconftest -q tests/test_torch_hopper.py
"""
import ctypes
import subprocess
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import _build

PROBE = Path(__file__).resolve().parent / "csrc" / "hopper_probe.cu"
TOL = 1e-4


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probes are Hopper kernels")
    lib = tmp_path_factory.mktemp("hopper") / "libhopper_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(PROBE)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).probe_run
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n", [(0, 64), (1, 64), (2, 64), (2, 128)])
def test_hopper_blocks_match_matmul(probe, mode, n):
    gen = torch.Generator(device="cuda").manual_seed(mode * 1000 + n)
    a, b, b2 = (torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                for shape in ((64, 64), (64, 64), (64, n)))
    c = torch.full((64, n), float("nan"), device="cuda")
    assert probe(mode, n, a.data_ptr(), b.data_ptr(), b2.data_ptr(), c.data_ptr()) == 0
    af, bf = a.double(), b.double()
    if mode == 0:
        want = af @ bf.T
    elif mode == 1:
        want = af @ bf
    else:
        want = (af @ bf.T).float().to(torch.bfloat16).double() @ b2.double()
    err = float((c.double() - want).abs().max() / want.abs().max())
    print(f"hopper probe mode {mode} n {n}: max |probe - matmul| / max |matmul| = {err:.3e}")
    assert err <= TOL
