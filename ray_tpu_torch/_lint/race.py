"""The port's race run: its mirrored runtime tests under the lock witness.

    python -m ray_tpu_torch._lint --race

runs the object-plane, chaos, actors, lock-witness and object-lifetime
test files (``tests/test_torch_{object_plane,chaos,actors,lock_witness,
object_lifetime}.py``) in one pytest process with
``RAY_TPU_TORCH_lock_witness=1`` and a sidecar file
(``RAY_TPU_TORCH_lock_witness_file``) that every process appends its
findings to: the driver, and through the inherited environment every
head, node daemon and worker it spawns. The run fails when pytest fails
or when the sidecar holds any lock-order inversion, from any process.

Run from a checkout of the repo (the test files are not part of the
package). Not part of the tier-1 suite: the witness wraps every lock the
runtime creates, which slows the files down.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Tuple

from .._private import lock_witness

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")
)
#: The whole run's limit: the files take about a minute under the witness.
TIMEOUT_S = 1800
#: The mirrored runtime files the race run drives, in this order.
RACE_FILES = [
    "tests/test_torch_object_plane.py",
    "tests/test_torch_chaos.py",
    "tests/test_torch_actors.py",
    "tests/test_torch_lock_witness.py",
    "tests/test_torch_object_lifetime.py",
]


def run() -> Tuple[int, str]:
    """Runs the race files under the witness; returns ``(pytest's exit
    code, the sidecar's text)``."""
    fd, sidecar = tempfile.mkstemp(prefix="rtpt_lock_witness_", suffix=".log")
    os.close(fd)
    env = {
        **os.environ,
        lock_witness.ENV_VAR: "1",
        lock_witness.FILE_ENV: sidecar,
        # The tests' root conftest imports the reference package, whose
        # JAX must stay on the CPU.
        "JAX_PLATFORMS": "cpu",
    }
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", *RACE_FILES, "-q",
             "-p", "no:cacheprovider"],
            cwd=REPO_ROOT, env=env, timeout=TIMEOUT_S,
        )
        with open(sidecar, encoding="utf-8") as f:
            return proc.returncode, f.read().strip()
    finally:
        os.unlink(sidecar)


def main() -> int:
    rc, findings = run()
    if findings:
        print("[race] lock-order inversions witnessed (all processes):")
        print(findings)
    n = findings.count("lock-order inversion")
    print(f"[race] pytest exit {rc}; {n} inversion(s) witnessed")
    if rc != 0:
        return rc
    return 1 if findings else 0
