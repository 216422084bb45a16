"""The port's native tools, built from its own sources (`csrc/`) at first
use into `_native/`, as `native_store` builds its library:

- `librtpt_client.so`: the C ABI client of the direct call plane
  (`csrc/rtpt_client.{c,h}`): a C or C++ caller of a deployed actor over
  its worker's direct socket, with the HMAC handshake of `transport` and
  the fastpath frames;
- `rtpt_client_test`: its driver (`csrc/rtpt_client_main.c`): a
  scripted sequence of calls, or a timed bytes call;
- `store_stress` and `store_stress_asan`: the pool store's crash harness
  (`csrc/stress_main.cpp` over `csrc/store.cpp`), writers and readers
  forked against one `/rtpt_stress_<pid>` pool with one writer SIGKILLed
  mid-operation each round; the second under AddressSanitizer.

`build(name)` returns the target's path, compiling it when it is missing
or older than one of its sources; a failed compile raises with the
compiler's output. Nothing here falls back.
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Tuple

_DIR = os.path.dirname(__file__)
CSRC = os.path.join(_DIR, "csrc")
NATIVE_DIR = os.path.join(_DIR, "_native")

_C = ["gcc", "-O2", "-std=c11", "-Wall", "-Wextra"]
_CXX = ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
_ASAN = ["-fsanitize=address", "-g", "-O1"]

# name -> (compiler and flags, files compiled, files it depends on, libraries)
TARGETS: Dict[str, Tuple[List[str], List[str], List[str], List[str]]] = {
    "librtpt_client.so": (_C + ["-fPIC", "-shared"], ["rtpt_client.c"],
                          ["rtpt_client.c", "rtpt_client.h"], []),
    "rtpt_client_test": (_C, ["rtpt_client_main.c", "rtpt_client.c"],
                         ["rtpt_client_main.c", "rtpt_client.c", "rtpt_client.h"], []),
    "store_stress": (_CXX, ["stress_main.cpp"], ["stress_main.cpp", "store.cpp"],
                     ["-lpthread", "-lrt"]),
    "store_stress_asan": (_CXX + _ASAN, ["stress_main.cpp"],
                          ["stress_main.cpp", "store.cpp"], ["-lpthread", "-lrt"]),
}

_lock = threading.Lock()


def sources() -> List[str]:
    """Every source file these targets compile or include."""
    return sorted({os.path.join(CSRC, f) for _, _, deps, _ in TARGETS.values() for f in deps})


def build(name: str) -> str:
    """The path of target `name` in `_native/`, built first if it is
    missing or older than a source. Raises `RuntimeError` with the
    compiler's output if the build fails."""
    flags, files, deps, libs = TARGETS[name]
    out = os.path.join(NATIVE_DIR, name)
    with _lock:
        newest = max(os.path.getmtime(os.path.join(CSRC, f)) for f in deps)
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        os.makedirs(NATIVE_DIR, exist_ok=True)
        # A private name, then an atomic rename: another process may be
        # running or building the same target.
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = flags + ["-o", tmp] + [os.path.join(CSRC, f) for f in files] + libs
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out
