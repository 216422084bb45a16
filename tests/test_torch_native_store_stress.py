"""Multi-process crash and stress coverage of the port's C++ pool store.
tests/test_native_store_stress.py, case for case, on the port's own
harness (`ray_tpu_torch/_private/csrc/stress_main.cpp`, built by
`native_tools.build` into `_private/_native/`): writers and readers
forked against one `/rtpt_stress_<pid>` pool, one writer SIGKILLed
mid-operation (often holding the process-shared robust mutex) each
round; the pool must stay consistent and usable. Bounded slices of the
full runs (`store_stress_asan 100 4` passes 100 rounds).
"""
import shutil
import subprocess

import pytest

from ray_tpu_torch._private import native_tools

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def test_stress_survives_sigkill_mid_operation():
    path = native_tools.build("store_stress")
    out = subprocess.run([path, "10", "4"], capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr.decode()
    assert b"stress OK" in out.stdout


def test_stress_asan_clean():
    path = native_tools.build("store_stress_asan")
    out = subprocess.run([path, "10", "4"], capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr.decode()
    assert b"AddressSanitizer" not in out.stderr
    assert b"stress OK" in out.stdout
