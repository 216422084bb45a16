"""Runtime environments: per-task/actor execution context.

Reference: python/ray/_private/runtime_env/ — a plugin system (pip,
conda, working_dir, py_modules, containers) materialized by a per-node
runtime-env agent before worker start, with URI-addressed packages
cached through the GCS KV. This implementation covers the
hermetic-code plugins that make sense on a shared host:

  env_vars:    {name: value} applied around task execution
  working_dir: local dir zipped at submission, shipped via the GCS KV,
               extracted once per node into the session cache, chdir'd
               + sys.path'd during execution
  py_modules:  list of local dirs shipped the same way, sys.path only

Plugins (pip, conda, container in `runtime_env_plugins`, registered on
import) own further keys through the registry below.

Workers are pooled, so activation is scoped (apply/restore) rather
than per-process (the reference starts dedicated workers per runtime
env; see worker_pool.cc per-env pools).
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import sys
import tempfile
import threading
import zipfile
from typing import Any, Dict, Optional

_NS = "__runtime_env__"
_VALID_KEYS = {"env_vars", "working_dir", "py_modules"}
_lock = threading.Lock()


class RuntimeEnvPlugin:
    """Extension point (reference: _private/runtime_env/plugin.py
    RuntimeEnvPlugin — validate/create/modify_context). A plugin owns
    one runtime_env key:

      validate(config)            raise on bad config (driver-side)
      package(config, client)     driver-side transform (e.g. upload)
      create(config, client)      worker-side materialization, cached
                                  per config hash; returns a context
      enter(context)              mutate os.environ / sys.path for the
                                  task (the activation wrapper restores
                                  both wholesale afterwards)
    """

    name: str = ""

    def validate(self, config: Any) -> None:  # pragma: no cover - default
        pass

    def package(self, config: Any, client) -> Any:
        return config

    def create(self, config: Any, client) -> Any:
        return config

    def enter(self, context: Any) -> None:
        pass


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    """Register a runtime_env plugin; its name becomes a valid key."""
    _PLUGINS[plugin.name] = plugin
    _VALID_KEYS.add(plugin.name)


_extracted: Dict[str, str] = {}  # uri -> local dir
# Driver-side package cache: (path, fingerprint) -> uri, so repeated
# .remote() calls don't re-zip the directory on the submission hot path.
_upload_cache: Dict[tuple, str] = {}


def _dir_fingerprint(path: str) -> tuple:
    """Cheap change detector: (count, total size, max mtime_ns)."""
    n = size = newest = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
        for fn in files:
            try:
                st = os.stat(os.path.join(root, fn))
            except OSError:
                continue
            n += 1
            size += st.st_size
            newest = max(newest, st.st_mtime_ns)
    return (n, size, newest)


def validate(runtime_env: Dict[str, Any]) -> None:
    bad = set(runtime_env) - _VALID_KEYS
    if bad:
        raise ValueError(
            f"Unsupported runtime_env keys {sorted(bad)}; "
            f"supported: {sorted(_VALID_KEYS)}"
        )
    for key, plugin in _PLUGINS.items():
        if key in runtime_env:
            plugin.validate(runtime_env[key])


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
            for fn in files:
                full = os.path.join(root, fn)
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def package(runtime_env: Dict[str, Any], client) -> Dict[str, Any]:
    """Driver-side: replace local dirs with content-addressed KV URIs
    (reference: URI-cached packaging via GCS KV)."""
    validate(runtime_env)
    out = dict(runtime_env)

    def upload(path: str) -> str:
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise ValueError(f"runtime_env dir not found: {path}")
        fp = _dir_fingerprint(path)
        with _lock:
            cached = _upload_cache.get((path, fp))
        if cached is not None:
            return cached
        blob = _zip_dir(path)
        uri = "kv://" + hashlib.sha1(blob).hexdigest()[:16]
        key = uri.encode()
        if not client.kv_exists(key, ns=_NS):
            client.kv_put(key, blob, ns=_NS)
        with _lock:
            _upload_cache[(path, fp)] = uri
        return uri

    if "working_dir" in out and not str(out["working_dir"]).startswith("kv://"):
        out["working_dir"] = upload(out["working_dir"])
    if "py_modules" in out:
        out["py_modules"] = [
            m if str(m).startswith("kv://") else upload(m)
            for m in out["py_modules"]
        ]
    for key, plugin in _PLUGINS.items():
        if key in out:
            out[key] = plugin.package(out[key], client)
    return out


def _ensure_extracted(uri: str, client) -> str:
    with _lock:
        if uri in _extracted:
            return _extracted[uri]
    blob = client.kv_get(uri.encode(), ns=_NS)
    if blob is None:
        raise RuntimeError(f"runtime_env package {uri} missing from KV")
    dest = os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "runtime_env", uri.replace("kv://", "")
    )
    if not os.path.isdir(dest):
        tmp = dest + f".tmp{os.getpid()}"
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.replace(tmp, dest)
        except OSError:  # another process won the race
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    with _lock:
        _extracted[uri] = dest
    return dest


@contextlib.contextmanager
def activate(runtime_env: Optional[Dict[str, Any]], client):
    """Worker-side: apply the env for the duration of one task."""
    if not runtime_env:
        yield
        return
    saved_env: Dict[str, Optional[str]] = {}
    saved_path = list(sys.path)
    saved_cwd = os.getcwd()
    saved_mods = set(sys.modules)
    entered_roots = []  # paths whose modules must not leak to other tasks
    try:
        for k, v in (runtime_env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        for uri in runtime_env.get("py_modules") or []:
            root = _ensure_extracted(uri, client)
            entered_roots.append(root)
            sys.path.insert(0, root)
        wd = runtime_env.get("working_dir")
        if wd:
            local = _ensure_extracted(wd, client)
            entered_roots.append(local)
            sys.path.insert(0, local)
            os.chdir(local)
        for key, plugin in _PLUGINS.items():
            if key in runtime_env:
                try:
                    ctx = plugin.create(runtime_env[key], client)
                    if isinstance(ctx, str):
                        entered_roots.append(ctx)
                    plugin.enter(ctx)
                except Exception as e:
                    from ..exceptions import RuntimeEnvSetupError

                    raise RuntimeEnvSetupError(
                        f"runtime_env plugin {key!r} failed: {e}"
                    ) from e
        yield
    finally:
        os.chdir(saved_cwd)
        sys.path[:] = saved_path
        # Workers are pooled: modules imported from this env's paths
        # must not stay importable for the NEXT task (the reference gets
        # this isolation from per-env worker pools; we get it by
        # evicting the env's modules from the import cache).
        for name in set(sys.modules) - saved_mods:
            m = sys.modules.get(name)
            f = getattr(m, "__file__", None) or ""
            if f and any(f.startswith(r + os.sep) for r in entered_roots):
                del sys.modules[name]
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


# Built-in plugins register on import (pip/conda/container); placed at
# module end so their `from .runtime_env import ...` sees a fully
# initialized module.
from . import runtime_env_plugins as _builtin_plugins  # noqa: E402,F401
