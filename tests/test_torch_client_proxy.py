"""The port's thin client (`ray_tpu_torch://`), tests/test_client_proxy.py
case for case, and a llama-tiny forward through a client.

Each client is a driver script in a subprocess whose only route to the
cluster is the `ray_tpu_torch://` address, with CUDA_VISIBLE_DEVICES
empty. Everything it creates is owned by a session process of the head,
which cleans up when the client goes. One module-scoped head; every test
has a deadline after which it fails instead of hanging, and every
subprocess and `get` a timeout.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from dataclasses import replace

import pytest
import torch

import ray_tpu_torch

DEADLINE_S = 120
CLIENT_TIMEOUT_S = 100
LOGITS_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def proxy_cluster():
    ray_tpu_torch.init(num_cpus=2, client_server_port=0)
    try:
        address = ray_tpu_torch.client_server_address()
        assert address.startswith("ray_tpu_torch://")
        yield address
    finally:
        ray_tpu_torch.shutdown()


def _run_client(address: str, body: str) -> str:
    """A driver script whose only route to the cluster is `address`, on
    a host that shows it no card."""
    script = textwrap.dedent(
        f"""
        import ray_tpu_torch
        ray_tpu_torch.init(address={address!r})
        """
    ) + textwrap.dedent(body)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=CLIENT_TIMEOUT_S, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode == 0, f"client failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_tasks_puts_roundtrip(proxy_cluster):
    out = _run_client(
        proxy_cluster,
        """
        import numpy as np

        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        assert ray_tpu_torch.get(double.remote(21), timeout=60) == 42

        # Dependency chain through proxy-owned refs.
        r1 = double.remote(10)
        r2 = double.remote(r1)
        assert ray_tpu_torch.get(r2, timeout=60) == 40

        # Large array: packed bytes across the proxy, both directions.
        arr = np.arange(300_000, dtype=np.int64)
        back = ray_tpu_torch.get(ray_tpu_torch.put(arr), timeout=60)
        assert (back == arr).all()

        # __main__-defined class: the session must never unpickle it.
        class Point:
            def __init__(self, x):
                self.x = x

        assert ray_tpu_torch.get(ray_tpu_torch.put(Point(7)), timeout=60).x == 7

        ready, pending = ray_tpu_torch.wait([r1, r2], num_returns=2, timeout=10)
        assert len(ready) == 2 and not pending
        print("TASKS-OK")
        """,
    )
    assert "TASKS-OK" in out


def test_actors_and_streaming(proxy_cluster):
    out = _run_client(
        proxy_cluster,
        """
        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        c = Counter.remote()
        assert ray_tpu_torch.get(c.add.remote(2), timeout=60) == 2
        assert ray_tpu_torch.get(c.add.remote(3), timeout=60) == 5

        @ray_tpu_torch.remote
        def gen(n):
            for i in range(n):
                yield i * i

        got = [ray_tpu_torch.get(r, timeout=60) for r in
               gen.options(num_returns="streaming").remote(4)]
        assert got == [0, 1, 4, 9], got
        print("ACTORS-OK")
        """,
    )
    assert "ACTORS-OK" in out


def test_named_actor_and_kv(proxy_cluster):
    _run_client(
        proxy_cluster,
        """
        @ray_tpu_torch.remote
        class Holder:
            def ping(self):
                return "pong"

        h = Holder.options(name="proxy_named", lifetime="detached").remote()
        assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
        """,
    )
    # Detached actor survives the client session; visible to the local
    # driver and to a second remote client.
    h = ray_tpu_torch.get_actor("proxy_named")
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
    _run_client(
        proxy_cluster,
        """
        h = ray_tpu_torch.get_actor("proxy_named")
        assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
        """,
    )
    ray_tpu_torch.kill(h)


def test_disconnect_cleans_up(proxy_cluster):
    # The client creates a named (but NON-detached) actor then exits
    # without shutdown; the session must kill it.
    _run_client(
        proxy_cluster,
        """
        import os

        @ray_tpu_torch.remote
        class Leaky:
            def pid(self):
                return os.getpid()

        a = Leaky.options(name="proxy_leaky").remote()
        assert ray_tpu_torch.get(a.pid.remote(), timeout=60) > 0
        os._exit(0)  # hard exit: no client-side cleanup at all
        """,
    )
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            h = ray_tpu_torch.get_actor("proxy_leaky")
            ray_tpu_torch.get(h.pid.remote(), timeout=5)
        except Exception:
            break  # dead or gone — cleaned up
        time.sleep(0.5)
    else:
        pytest.fail("non-detached actor survived client disconnect")


def test_llama_tiny_forward_through_a_client_equals_the_in_process_one(proxy_cluster):
    """A client with no card runs llama-tiny's forward in a task and in an
    actor; it gets host float32 tensors within LOGITS_ATOL of this
    process's forward of the same ids on the same seeded weights."""
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    cfg = replace(CONFIGS["llama-tiny"], dtype=torch.float32)
    ids = torch.arange(40, dtype=torch.long).remainder(cfg.vocab_size)[None] * 7 % cfg.vocab_size
    with torch.inference_mode():
        want = LlamaForCausalLM(cfg, device="cpu")(ids)[0, -1]
    out = _run_client(
        proxy_cluster,
        f"""
        import json
        import torch

        def forward(ids):
            from dataclasses import replace
            from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

            cfg = replace(CONFIGS["llama-tiny"], dtype=torch.float32)
            with torch.inference_mode():
                return LlamaForCausalLM(cfg, device="cpu")(ids)[0, -1]

        @ray_tpu_torch.remote
        class Model:
            def forward(self, ids):
                return forward(ids)

        ids = torch.tensor({ids.tolist()})
        task = ray_tpu_torch.get(ray_tpu_torch.remote(forward).remote(ids), timeout=60)
        actor = ray_tpu_torch.get(Model.remote().forward.remote(ids), timeout=60)
        print(json.dumps({{name: [str(t.dtype), t.device.type, t.tolist()]
                          for name, t in (("task", task), ("actor", actor))}}))
        """,
    )
    got = json.loads(out.strip().splitlines()[-1])
    for name in ("task", "actor"):
        dtype, device, values = got[name]
        assert (dtype, device) == ("torch.float32", "cpu"), name
        # The same float32 model in another process: only a thread
        # count's summation order could differ.
        torch.testing.assert_close(torch.tensor(values, dtype=torch.float32), want,
                                   rtol=0, atol=LOGITS_ATOL, msg=name)
