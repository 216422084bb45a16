"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled by `nvcc` for Hopper (`sm_90a`). All sources build
in parallel, one `nvcc` each. A library is named after the hash of its
source, the shared headers and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is. Libraries go to
`ray_tpu_torch/_build/`, which git ignores, each beside the register and
spill report `ptxas -v` printed for it (`ptxas_report`). A failed build
raises: there is no retry and no fallback.

Several processes may build at once (the ranks of a world on one card):
a build holds an exclusive `flock` on `_build/.lock` and looks again for
each library once it has the lock, so one process compiles and the
others load what it wrote. A library and its report each appear by an
atomic rename, never half-written.

The helpers below call a kernel's C entry point, which launches on
PyTorch's current stream and returns a `cudaError_t`; `launch` raises if
it is not 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def _built(lib: Path) -> bool:
    return lib.exists() and _report_path(lib).exists()


@contextlib.contextmanager
def _build_dir_lock():
    """An exclusive lock on the build directory across processes, released
    by the kernel if its holder dies."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(todo: Dict[Path, Path]) -> None:
    """Compiles each source of `todo` (source -> library) not yet built by
    another process; call with the build directory locked."""
    pending = []
    for src, lib in todo.items():
        if _built(lib):
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in pending:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
        else:
            report = _report_path(lib)
            report.with_suffix(f".tmp{os.getpid()}").write_text(out)
            os.replace(report.with_suffix(f".tmp{os.getpid()}"), report)
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def build() -> Dict[str, ctypes.CDLL]:
    """Compile every source not yet built (in parallel), load all of
    them, and return the libraries by source name."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = {s: _library_path(s) for s in sources if s.stem not in _libs}
        if not all(_built(lib) for lib in todo.values()):
            with _build_dir_lock():
                _compile(todo)
        for src, lib in todo.items():
            _libs[src.stem] = ctypes.CDLL(str(lib))
        return dict(_libs)


def ptxas_report(name: str) -> str:
    """What `ptxas -v` printed when `csrc/<name>.cu` was built: each
    kernel's registers, stack, spill bytes and static shared memory."""
    build()
    return _report_path(_library_path(CSRC / f"{name}.cu")).read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu`."""
    lib = _libs.get(name)
    if lib is None:
        lib = build()[name]
    return lib


def launch(lib_name: str, fn_name: str, argtypes: Sequence, *args) -> None:
    """Calls `fn_name` of `csrc/<lib_name>.cu` and raises with CUDA's
    message if it returns an error."""
    fn = _functions.get((lib_name, fn_name))
    if fn is None:
        lib = library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _functions[(lib_name, fn_name)] = fn
    err = fn(*args)
    if err != 0:
        msg = library(lib_name).kernel_error_string(err).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err} ({msg})")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous, with its data 16-byte aligned (the kernels read
    and write 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors (got {t.device})")
