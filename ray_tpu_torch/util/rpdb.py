"""Remote pdb for tasks and actors (reference: python/ray/util/rpdb.py).

``ray_tpu_torch.util.rpdb.set_trace()`` inside remote code opens a debugger
server on the worker, registers it in the GCS KV under ``rpdb:<pid>``,
and blocks until a client attaches. ``python -m ray_tpu_torch debug`` (scripts/cli.py)
lists active sessions and bridges the terminal; programmatic clients
connect with :func:`connect` (what the test does).

The wire is a bare socket speaking pdb's own line protocol — no
custom framing, so `telnet`/`nc` also work.
"""
from __future__ import annotations

import os
import pdb
import socket
import sys
from typing import List, Optional, Tuple

_KV_PREFIX = b"rpdb:"


class _SockIO:
    """File-ish adapter pdb can read/write (readline-based)."""

    def __init__(self, sock: socket.socket):
        self._f = sock.makefile("rw", buffering=1)

    def readline(self):
        return self._f.readline()

    def write(self, data):
        self._f.write(data)
        return len(data)

    def flush(self):
        self._f.flush()


class _RemotePdb(pdb.Pdb):
    def __init__(self, io: _SockIO):
        super().__init__(stdin=io, stdout=io)
        self.use_rawinput = False
        self.prompt = "(rpdb) "


def _kv_put(key: bytes, value: bytes) -> None:
    from ray_tpu_torch._private.worker import global_client

    global_client().request(
        {"type": "kv_put", "key": key, "value": value, "overwrite": True}
    )


def _kv_del(key: bytes) -> None:
    from ray_tpu_torch._private.worker import global_client

    global_client().request({"type": "kv_del", "key": key})


def sessions() -> List[Tuple[str, str]]:
    """[(name, host:port)] of debugger sessions currently waiting."""
    from ray_tpu_torch._private.worker import global_client

    reply = global_client().request(
        {"type": "kv_keys", "prefix": _KV_PREFIX}
    )
    out = []
    for key in reply.get("keys", []):
        val = global_client().request({"type": "kv_get", "key": key})
        v = val.get("value")
        if v:
            out.append((key[len(_KV_PREFIX):].decode(), v.decode()))
    return out


def set_trace(frame=None) -> None:
    """Break here and wait for one debugger client."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # Bind all interfaces, advertise the node's reachable IP: a session
    # on another host must be attachable from the head's terminal.
    srv.bind(("0.0.0.0", 0))
    srv.listen(1)
    from ray_tpu_torch._private import transport

    host = transport.node_ip()
    port = srv.getsockname()[1]
    name = f"{os.getpid()}"
    key = _KV_PREFIX + name.encode()
    _kv_put(key, f"{host}:{port}".encode())
    sys.stderr.write(
        f"rpdb: waiting for a debugger on {host}:{port} "
        f"(`python -m ray_tpu_torch debug` or `nc {host} {port}`)\n"
    )
    try:
        conn, _ = srv.accept()
    finally:
        _kv_del(key)
        srv.close()
    io = _SockIO(conn)
    dbg = _RemotePdb(io)
    dbg.set_trace(frame or sys._getframe().f_back)


def connect(addr: str) -> socket.socket:
    """Programmatic attach: returns the connected socket."""
    host, _, port = addr.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.connect((host, int(port)))
    return s


def bridge(addr: str) -> None:
    """Interactive attach: stdin -> socket, socket -> stdout (the CLI's
    `python -m ray_tpu_torch debug` loop)."""
    import threading

    s = connect(addr)

    def pump_in():
        try:
            for line in sys.stdin:
                s.sendall(line.encode())
        except (OSError, ValueError):
            pass

    t = threading.Thread(target=pump_in, daemon=True)
    t.start()
    try:
        while True:
            data = s.recv(4096)
            if not data:
                break
            sys.stdout.write(data.decode(errors="replace"))
            sys.stdout.flush()
    except KeyboardInterrupt:
        pass
    finally:
        s.close()
