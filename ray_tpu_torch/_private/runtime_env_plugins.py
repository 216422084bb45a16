"""Built-in runtime_env plugins: pip, conda, container.

Reference: python/ray/_private/runtime_env/{pip,conda,container}.py —
the reference's per-node agent materializes a virtualenv/conda env/
container per runtime_env and starts dedicated workers inside it. Here
workers are pooled and activation is task-scoped, so:

  pip:       a cached venv (--system-site-packages, so the system's
             torch and its CUDA stay importable) is built per
             requirements hash under the port's temp root
             (``config.temp_root()/runtime_env/pip/<hash>``) and its
             site-packages is prepended to sys.path for the task — same
             isolation boundary as the reference's venv, minus
             process-level exclusivity. A failed build fails the task;
             it never runs in the base environment.
             Requirements resolve offline from local paths/wheels
             (``--no-index``); a requirement only an index could give
             fails with the pip error verbatim.
  conda:     gated — requires a conda binary on the host.
  container: gated — requires docker/podman; the pooled-worker model
             cannot re-exec into a container image, so this plugin only
             validates and fails loudly (the reference starts the
             worker inside the image, which needs node-agent authority
             we deliberately keep out of the shared-host build).
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
from typing import Any, Dict, List

from .config import temp_root
from .runtime_env import RuntimeEnvPlugin, register_plugin

_lock = threading.Lock()


class PipPlugin(RuntimeEnvPlugin):
    name = "pip"

    def validate(self, config: Any) -> None:
        pkgs = self._packages(config)
        if not isinstance(pkgs, list) or not all(
            isinstance(p, str) for p in pkgs
        ):
            raise ValueError(
                "runtime_env['pip'] must be a list of requirement strings "
                "or {'packages': [...]}"
            )

    @staticmethod
    def _packages(config: Any) -> List[str]:
        if isinstance(config, dict):
            return list(config.get("packages", []))
        return list(config)

    def create(self, config: Any, client) -> str:
        """Build (or reuse) the venv for this requirements set; returns
        its site-packages dir."""
        pkgs = sorted(self._packages(config))
        h = hashlib.sha1(json.dumps(pkgs).encode()).hexdigest()[:16]
        base = os.path.join(temp_root(), "runtime_env", "pip", h)
        marker = os.path.join(base, ".ready")
        with _lock:
            if not os.path.exists(marker):
                self._build(base, pkgs, marker)
        sites = glob.glob(
            os.path.join(base, "lib", "python*", "site-packages")
        )
        if not sites:
            raise RuntimeError(f"venv at {base} has no site-packages")
        return sites[0]

    def _build(self, base: str, pkgs: List[str], marker: str) -> None:
        tmp = base + f".tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", tmp],
            check=True,
            capture_output=True,
        )
        if pkgs:
            pip = os.path.join(tmp, "bin", "pip")
            proc = subprocess.run(
                # Never an index: requirements resolve from local paths
                # and wheels only, and no pip self-check goes out.
                [pip, "install", "--no-input", "--no-index",
                 "--disable-pip-version-check", *pkgs],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"pip install failed:\n{proc.stderr[-2000:]}"
                )
        try:
            os.replace(tmp, base)
        except OSError:  # another process won the build race
            shutil.rmtree(tmp, ignore_errors=True)
        with open(marker, "w") as f:
            f.write("ok")

    def enter(self, site_packages: str) -> None:
        sys.path.insert(0, site_packages)


class CondaPlugin(RuntimeEnvPlugin):
    name = "conda"

    def validate(self, config: Any) -> None:
        if shutil.which("conda") is None:
            raise ValueError(
                "runtime_env['conda'] requires a conda binary on PATH "
                "(not present on this host)"
            )

    def create(self, config: Any, client) -> Any:
        if shutil.which("conda") is None:
            raise RuntimeError("conda binary not found on this node")
        # Env-name form only: activate an EXISTING conda env by
        # prepending its site-packages (creating envs from a spec dict
        # needs solver egress).
        if not isinstance(config, str):
            raise RuntimeError(
                "only the env-name form of runtime_env['conda'] is "
                "supported"
            )
        out = subprocess.run(
            ["conda", "env", "list", "--json"],
            capture_output=True,
            text=True,
            check=True,
        )
        for env_path in json.loads(out.stdout).get("envs", []):
            if os.path.basename(env_path) == config:
                sites = glob.glob(
                    os.path.join(env_path, "lib", "python*", "site-packages")
                )
                if sites:
                    return sites[0]
        raise RuntimeError(f"conda env {config!r} not found")

    def enter(self, site_packages: str) -> None:
        sys.path.insert(0, site_packages)


class ContainerPlugin(RuntimeEnvPlugin):
    name = "container"

    def validate(self, config: Any) -> None:
        if shutil.which("docker") is None and shutil.which("podman") is None:
            raise ValueError(
                "runtime_env['container'] requires docker or podman on the "
                "host (not present)"
            )

    def create(self, config: Any, client) -> Any:
        raise RuntimeError(
            "container runtime_env is not supported by the pooled-worker "
            "execution model (workers cannot re-exec into an image); run "
            "the job under the image instead"
        )


register_plugin(PipPlugin())
register_plugin(CondaPlugin())
register_plugin(ContainerPlugin())
