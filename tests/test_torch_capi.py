"""The port's C ABI client (`ray_tpu_torch/_private/csrc/rtpt_client.c`):
a pure-C caller drives a live port actor over the port's worker socket:
frame codec, HMAC handshake, pickle writer and reader, all written anew
in C, so this also holds the port's fastpath wire format end to end.
tests/test_capi.py, case for case, with the driver built by the port
itself (`native_tools.build`), a deadline on the test and a timeout on
every `get`.
"""
import signal
import subprocess
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import native_tools

DEADLINE_S = 120
GET_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def client_bin():
    return native_tools.build("rtpt_client_test")


@ray_tpu_torch.remote
class Target:
    def ping(self):
        return "pong"

    def add(self, a, b):
        return a + b

    def add1(self, a):
        return a + 1

    def fmul(self, x):
        return x * 2.0

    def echo_len(self, b):
        assert isinstance(b, bytes)
        return len(b)

    def greet(self, name):
        return f"hello {name}"

    def boom(self):
        raise ValueError("kaboom")


def direct_info(handle):
    """(direct socket, actor id hex, session authkey hex) of a live actor."""
    from ray_tpu_torch._private.worker import global_client

    client = global_client()
    aid = handle._actor_id.binary()
    deadline = time.time() + 30
    while time.time() < deadline:
        reply = client.request({"type": "get_actor_direct", "actor_id": aid})
        if reply.get("addr"):
            return reply["addr"], aid.hex(), client._authkey.hex()
        time.sleep(0.1)
    raise TimeoutError("actor direct addr not available")


def test_c_client_calls_live_actor(cluster, client_bin):
    t = Target.remote()
    assert ray_tpu_torch.get(t.ping.remote(), timeout=GET_TIMEOUT_S) == "pong"  # ALIVE
    addr, aid_hex, key_hex = direct_info(t)
    assert addr.startswith("/tmp/rtpt-")  # the port's worker socket

    out = subprocess.run([client_bin, addr, key_hex, aid_hex], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "ping str pong" in lines
    assert "add int 42" in lines
    assert "add1 int 1234567890123456790" in lines
    assert "fmul float 3" in lines
    assert "echo_len int 300" in lines
    assert "greet str hello wörld" in lines
    assert "boom rc -3" in lines  # RTPT_ERR_REMOTE, the connection survives
    assert "ping2 str pong" in lines
    assert lines[-1] == "ok"

    # The Python side still talks to the same actor afterwards.
    assert ray_tpu_torch.get(t.add.remote(1, 2), timeout=GET_TIMEOUT_S) == 3
