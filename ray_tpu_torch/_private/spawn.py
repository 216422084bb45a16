"""Worker process spawning: fork-server fast path + Popen fallback.

Reference: worker_pool.cc StartWorkerProcess — the pool owns process
creation so callers (scheduler, raylet) just ask for a worker. Here
`WorkerSpawner.spawn()` forks a warm child off the node's zygote
(zygote.py, ~5 ms) and falls back to a cold `python -m worker_main`
subprocess if the zygote is unavailable. GPU workers always take the
cold path: CUDA does not survive fork(), and CUDA_VISIBLE_DEVICES is read
once, when CUDA starts, so each GPU worker needs a fresh interpreter with
its own device ids in the env. Every other worker is pinned to no card
(CUDA_VISIBLE_DEVICES=""), the counterpart of the reference's
CPU-pinned non-TPU workers.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional

_CUDA_VISIBLE = "CUDA_VISIBLE_DEVICES"


class ForkedProc:
    """Popen-shaped handle for a process forked by the zygote (which is
    its parent — we cannot waitpid it, only signal/poll by pid).

    The pid may arrive asynchronously: ``spawn()`` pipelines the fork
    request and returns immediately; the spawner's reply reader
    resolves the pid (or marks the fork failed) when the zygote
    answers. Signal/poll calls briefly wait for that resolution."""

    def __init__(self, pid: Optional[int] = None,
                 on_fail: Optional[callable] = None,
                 fallback: Optional[callable] = None,
                 entity: str = ""):
        # Flight-recorder identity (the worker id this fork is for).
        self._entity = entity
        self._pid = pid
        self._resolved = threading.Event()
        if pid is not None:
            self._resolved.set()
        self._returncode: Optional[int] = None
        self._on_fail = on_fail
        # Cold-path escape: () -> Popen. A zygote whose fork() fails
        # (EAGAIN, rlimit) doesn't doom the worker — the spawn retries
        # as a direct subprocess before anyone is told of a death.
        self._fallback = fallback
        self._popen: Optional[subprocess.Popen] = None
        self._pending_signal: Optional[int] = None

    @property
    def pid(self) -> int:
        """Non-blocking: 0 while the fork is still in flight. Callers
        (state API, log labels) read this under the control-plane lock,
        so it must NEVER wait on the zygote."""
        return self._pid or 0

    def _resolve(self, pid: int) -> None:
        self._pid = pid
        from . import events as _events

        _events.record(
            _events.WORKER, self._entity, "FORKED", {"pid": pid}
        )
        self._resolved.set()
        sig, self._pending_signal = self._pending_signal, None
        if sig is not None:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass

    def _fail(self, use_fallback: bool = True) -> None:
        fallback, self._fallback = self._fallback, None
        if not use_fallback:
            # Ambiguous failure (zygote died mid-request): the fork may
            # have happened and the child may be about to register. A
            # cold-path respawn here would mint a SECOND process with
            # the same worker id; let the death path assign a fresh id.
            fallback = None
        if fallback is not None:
            try:
                child = fallback()
            except Exception:  # noqa: BLE001 - cold path failed too
                child = None
            if child is not None:
                self._popen = child  # direct child: reap via Popen.poll
                self._resolve(child.pid)
                return
        from . import events as _events

        _events.record(_events.WORKER, self._entity, "FORK_FAILED")
        self._returncode = 1
        self._resolved.set()
        if self._on_fail is not None:
            try:
                self._on_fail()
            except Exception:  # noqa: BLE001 - death bookkeeping best-effort
                pass

    def poll(self) -> Optional[int]:
        if self._returncode is not None:
            return self._returncode
        if not self._resolved.is_set():
            return None  # fork still in flight
        if self._popen is not None:
            # Cold-path fallback child: a real Popen — poll reaps it.
            rc = self._popen.poll()
            if rc is not None:
                self._returncode = rc
            return rc
        try:
            os.kill(self._pid, 0)
            return None
        except ProcessLookupError:
            self._returncode = 0  # exit status unknowable: not our child
            return self._returncode
        except PermissionError:
            return None

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self._returncode or 0

    def _signal(self, sig: int) -> None:
        if not self._resolved.is_set():
            # Fork in flight: deliver the moment the pid lands (the
            # reply loop runs _resolve) so a kill is never lost.
            self._pending_signal = sig
            if not self._resolved.is_set():
                return
        pid = self._pid or 0
        if pid <= 0:
            return  # fork failed: nothing to signal
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)


class WorkerSpawner:
    """One per control-plane process (GCS head / raylet).

    Fork requests are PIPELINED: ``spawn()`` writes the request and
    returns an unresolved :class:`ForkedProc` immediately; a reply
    reader thread resolves pids FIFO as the zygote answers. The
    scheduler thread therefore never blocks on a fork — a burst of N
    actor creations issues N fork requests back-to-back (reference:
    worker_pool.cc StartWorkerProcess is likewise async; the pool
    learns the pid from the registration callback)."""

    def __init__(self, base_env: Dict[str, str]):
        self._base_env = dict(base_env)
        self._lock = threading.Lock()
        self._zygote: Optional[subprocess.Popen] = None
        # FIFO of ForkedProcs awaiting their pid from the CURRENT
        # zygote (replies are in request order; a new zygote gets a
        # fresh deque captured by its own reader thread).
        self._awaiting: "deque[ForkedProc]" = deque()

    def _ensure_zygote(self) -> Optional[subprocess.Popen]:
        z = self._zygote
        if z is not None and z.poll() is None:
            return z
        env = dict(os.environ)
        env.update(self._base_env)
        # The zygote's interpreter sees no card (it imports the core
        # once, and its forks inherit the env); GPU workers never fork
        # from it.
        env[_CUDA_VISIBLE] = ""
        env["PYTHONUNBUFFERED"] = "1"
        try:
            self._zygote = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.zygote"],
                env=env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
            )
        except Exception:  # noqa: BLE001
            self._zygote = None
            return None
        self._awaiting = deque()
        threading.Thread(
            target=self._reply_loop,
            args=(self._zygote, self._awaiting),
            name="zygote-replies",
            daemon=True,
        ).start()
        return self._zygote

    def _reply_loop(self, z: subprocess.Popen,
                    awaiting: "deque[ForkedProc]") -> None:
        for line in z.stdout:
            try:
                reply = json.loads(line)
            except ValueError:
                reply = {}
            try:
                proc = awaiting.popleft()
            except IndexError:
                continue  # reply with no waiter: protocol desync
            pid = reply.get("pid")
            if pid:
                proc._resolve(pid)
            else:
                proc._fail()
        # Zygote died: every queued fork is lost. Do NOT hold the
        # spawner lock while failing procs — their on_fail callbacks
        # take the control-plane lock (opposite order to spawn()).
        with self._lock:
            if self._zygote is z:
                self._zygote = None
        while True:
            try:
                awaiting.popleft()._fail(use_fallback=False)
            except IndexError:
                break

    def spawn(self, env: Dict[str, str], log_path: str, gpu: bool = False,
              on_fail=None):
        """Returns a Popen-shaped handle (ForkedProc or Popen)."""
        from . import events as _events

        wid_hex = env.get("RAY_TPU_TORCH_WORKER_ID", "")
        _events.record(
            _events.WORKER, wid_hex, "FORK_REQUESTED", {"gpu": gpu}
        )
        if not gpu:
            with self._lock:
                z = self._ensure_zygote()
                if z is not None:
                    try:
                        env = dict(env)
                        env["RAY_TPU_TORCH_SPAWNED_AT"] = repr(time.time())
                        req = {"env": env, "log": log_path}
                        proc = ForkedProc(
                            on_fail=on_fail,
                            # fork() failing inside a live zygote
                            # (EAGAIN, zygote-local rlimit) escapes to a
                            # direct Popen instead of a worker death.
                            fallback=lambda e=dict(env): self._cold_spawn(
                                e, log_path, gpu
                            ),
                            entity=wid_hex,
                        )
                        self._awaiting.append(proc)
                        z.stdin.write((json.dumps(req) + "\n").encode())
                        z.stdin.flush()
                        return proc
                    except Exception:  # noqa: BLE001 - zygote died: cold path
                        try:
                            self._awaiting.remove(proc)
                        except ValueError:
                            pass
                        try:
                            z.kill()
                        except Exception:  # noqa: BLE001
                            pass
                        self._zygote = None
        return self._cold_spawn(env, log_path, gpu)

    def _cold_spawn(self, env: Dict[str, str], log_path: str,
                    gpu: bool) -> subprocess.Popen:
        full_env = dict(os.environ)
        full_env.update(self._base_env)
        full_env.update(env)
        for k, v in list(full_env.items()):
            if v == "":
                full_env.pop(k, None)
        # Set after the "" sweep above: an empty CUDA_VISIBLE_DEVICES
        # hides every card, where an unset one would show them all.
        full_env[_CUDA_VISIBLE] = env.get(_CUDA_VISIBLE, "") if gpu else ""
        out = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
                env=full_env,
                stdout=out,
                stderr=subprocess.STDOUT,
            )
        finally:
            out.close()
        from . import events as _events

        _events.record(
            _events.WORKER, full_env.get("RAY_TPU_TORCH_WORKER_ID", ""),
            "FORKED", {"pid": proc.pid, "cold": True},
        )
        return proc

    def shutdown(self) -> None:
        with self._lock:
            z, self._zygote = self._zygote, None
        if z is not None:
            try:
                z.stdin.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                z.terminate()
                z.wait(timeout=2)
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the zygote is killed below when it will not terminate
                try:
                    z.kill()
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
                    pass
