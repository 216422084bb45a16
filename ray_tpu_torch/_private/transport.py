"""Address parsing + listener/connection construction for the control
and data planes.

Reference: src/ray/rpc/ — the reference talks gRPC over TCP between all
daemons and unix sockets between a worker and its local raylet. Here
both planes ride multiprocessing.connection (length-prefixed pickle
frames with HMAC challenge auth): AF_UNIX for on-host peers (the fast
path) and AF_INET for cross-host peers. An address is either a
filesystem path (AF_UNIX) or "host:port" (AF_INET).
"""
from __future__ import annotations

import socket
from multiprocessing.connection import Client as MpClient
from multiprocessing.connection import Connection, Listener
from typing import Tuple, Union

Address = Union[str, Tuple[str, int]]


def is_tcp_address(address: str) -> bool:
    """"host:port" (exactly one colon, numeric port) vs a unix path."""
    if address.startswith("/") or address.startswith("."):
        return False
    host, sep, port = address.rpartition(":")
    return bool(sep) and bool(host) and port.isdigit()


def parse_address(address: str) -> Tuple[str, Address]:
    """Returns (family, mp_address) for multiprocessing.connection."""
    if is_tcp_address(address):
        host, _, port = address.rpartition(":")
        return "AF_INET", (host, int(port))
    return "AF_UNIX", address


def format_address(mp_address: Address) -> str:
    if isinstance(mp_address, tuple):
        return f"{mp_address[0]}:{mp_address[1]}"
    return mp_address


import hmac as _hmac

# Connection auth. Two schemes, picked by transport family:
#
# - AF_UNIX (the hot path: every local worker/direct/fetch conn): a
#   single-round-trip static token — client proves key knowledge with
#   its first frame, server proves back with its reply. Unix sockets
#   are kernel-local (no wire to sniff) and the paths carry 128-bit
#   random ids under the session dir, so a static per-session token is
#   sound; the old 4-message multiprocessing challenge serialized
#   through one accept loop was the actor-creation throughput ceiling.
#
# - AF_INET (cross-host control/transfer planes): a fresh-nonce
#   challenge-response both ways (multiprocessing's own scheme, run by
#   us so the accept loop still never blocks on it). A static token
#   over TCP would let a passive network observer replay it; a fresh
#   challenge yields nothing reusable.
_CLIENT_TAG = b"rtpu-conn-auth-v1:client"
_SERVER_TAG = b"rtpu-conn-auth-v1:server"
_HANDSHAKE_TIMEOUT_S = 20.0


class AuthError(ConnectionError):
    pass


def _token(authkey: bytes, tag: bytes) -> bytes:
    return _hmac.new(authkey, tag, "sha256").digest()


def make_listener(address: str, authkey: bytes) -> Listener:
    """Binds WITHOUT multiprocessing auth: ``accept()`` returns
    immediately and the caller MUST run :func:`server_handshake` on
    each accepted conn (ideally on that conn's own thread) before
    trusting it. Deferring keeps a connect storm of N workers from
    serializing N handshakes through one accept loop."""
    family, addr = parse_address(address)
    return Listener(addr, family=family, authkey=None)


def server_handshake(conn: Connection, authkey: bytes,
                     tcp: bool = False) -> None:
    """Verify the peer (token over unix, fresh challenge over TCP),
    then prove our own identity back."""
    if tcp:
        from multiprocessing.connection import (
            answer_challenge,
            deliver_challenge,
        )

        deliver_challenge(conn, authkey)
        answer_challenge(conn, authkey)
        return
    if not conn.poll(_HANDSHAKE_TIMEOUT_S):
        raise AuthError("handshake timeout")
    buf = conn.recv_bytes(maxlength=64)
    if not _hmac.compare_digest(buf, _token(authkey, _CLIENT_TAG)):
        raise AuthError("bad client token")
    conn.send_bytes(_token(authkey, _SERVER_TAG))


def listener_address(listener: Listener) -> str:
    """Concrete address after bind (resolves port 0 to the real port)."""
    return format_address(listener.address)


def connect(address: str, authkey: bytes) -> Connection:
    from . import chaos as _chaos

    if _chaos._active is not None:
        # Chaos 'connect' rules: delay or refuse establishment — the
        # failure mode every reconnect/backoff path must absorb.
        _chaos._active.on_connect(address)
    family, addr = parse_address(address)
    if family == "AF_INET":
        # Challenge-response (sniff-safe) — multiprocessing's client
        # side runs it against our server_handshake(tcp=True).
        return MpClient(addr, family=family, authkey=authkey)
    conn = MpClient(addr, family=family, authkey=None)
    try:
        conn.send_bytes(_token(authkey, _CLIENT_TAG))
        if not conn.poll(_HANDSHAKE_TIMEOUT_S):
            raise AuthError("handshake timeout")
        buf = conn.recv_bytes(maxlength=64)
        if not _hmac.compare_digest(buf, _token(authkey, _SERVER_TAG)):
            raise AuthError("bad server token")
    except BaseException:
        conn.close()
        raise
    return conn


def node_ip() -> str:
    """This host's primary outbound IP (reference:
    python/ray/_private/services.py get_node_ip_address)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # No packet is sent; this just selects the route.
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
