"""Loader for the native control-plane hot path (the port's own
`csrc/fastpath.c`, built at first use into `_native/`).

Reference: the compiled Cython submit/receive path (_raylet.pyx:3996)
and the hand-rolled encodings of the hot RPCs. Builds the CPython
extension on first import if missing (same pattern as native_store);
falls back to pure-Python/pickle when no toolchain is available —
`available()` tells callers which path is live, and `build_error` holds
the compiler's complaint.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(os.path.dirname(__file__), "csrc", "fastpath.c")
_EXT = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
_MOD_PATH = os.path.join(_NATIVE_DIR, f"fastpath{_EXT}")

_mod = None
_tried = False
_lock = threading.Lock()
#: Why the last build failed (the compiler's stderr), or None.
build_error = None


def _build() -> bool:
    global build_error
    os.makedirs(_NATIVE_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    # Build to a private temp name, then rename: every process in a
    # cluster loads this module, and a half-written .so from a build
    # race would poison them all (rename within a dir is atomic).
    tmp = f"{_MOD_PATH}.build{os.getpid()}"
    try:
        subprocess.run(
            [
                "gcc", "-O2", "-std=c11", "-fPIC", "-shared",
                "-Wall", "-Wextra", f"-I{include}",
                "-o", tmp, _SRC,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _MOD_PATH)
        build_error = None
        return True
    except Exception as e:  # noqa: BLE001 - no toolchain → pickle fallback
        build_error = (getattr(e, "stderr", None) or b"").decode(errors="replace") or repr(e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get():
    """The extension module, or None when unavailable."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    with _lock:
        if _mod is not None or _tried:
            return _mod
        if not os.path.exists(_MOD_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_MOD_PATH)
        ):
            _build()
        if os.path.exists(_MOD_PATH):
            try:
                spec = importlib.util.spec_from_file_location(
                    "fastpath", _MOD_PATH
                )
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _mod = mod
            except Exception:  # noqa: BLE001 - stale/foreign binary
                _mod = None
        _tried = True
        return _mod


def available() -> bool:
    return get() is not None
