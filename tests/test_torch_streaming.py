"""The port's streaming generators, through tasks, actors, a Serve handle
and Serve's HTTP proxy: tests/test_streaming.py, case for case, on the
port's runtime. Every test has a deadline after which it fails instead
of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Streaming generators: num_returns="streaming" end to end.

Reference behavior: python/ray/_raylet.pyx:1289 (streaming-generator
reporting) + src/ray/core_worker/task_manager.h:208 — each yield seals
as its own object, the consumer iterates refs while the task runs.
"""
import signal
import socket
import time

import pytest

import ray_tpu_torch

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


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_returns="streaming")
def count_stream(n, delay=0.0):
    for i in range(n):
        if delay:
            time.sleep(delay)
        yield i * 10


@ray_tpu_torch.remote(num_returns="streaming")
def failing_stream():
    yield 1
    yield 2
    raise ValueError("boom mid-stream")


def test_stream_basic(cluster):
    gen = count_stream.remote(5)
    assert isinstance(gen, ray_tpu_torch.ObjectRefGenerator)
    vals = [ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S) for ref in gen]
    assert vals == [0, 10, 20, 30, 40]


def test_stream_observes_partial_output_before_completion(cluster):
    """The defining property: the consumer sees early yields while the
    producer is still running (here: still sleeping between yields)."""
    t0 = time.monotonic()
    gen = count_stream.remote(6, delay=0.5)
    first = ray_tpu_torch.get(next(gen), timeout=GET_TIMEOUT_S)
    first_latency = time.monotonic() - t0
    assert first == 0
    # Full stream takes >=3s of producer sleeps; the first item must
    # arrive while most of that is still ahead.
    assert first_latency < 2.0, f"first item took {first_latency:.1f}s"
    rest = [ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S) for r in gen]
    assert rest == [10, 20, 30, 40, 50]


def test_stream_error_surfaces_after_last_yield(cluster):
    gen = failing_stream.remote()
    assert ray_tpu_torch.get(next(gen), timeout=GET_TIMEOUT_S) == 1
    assert ray_tpu_torch.get(next(gen), timeout=GET_TIMEOUT_S) == 2
    with pytest.raises(ValueError, match="boom mid-stream"):
        next(gen)


def test_stream_non_generator_returns_single_item(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def plain():
        return 42

    gen = plain.remote()
    assert ray_tpu_torch.get(next(gen), timeout=GET_TIMEOUT_S) == 42
    with pytest.raises(StopIteration):
        next(gen)


def test_actor_method_streaming(cluster):
    @ray_tpu_torch.remote
    class Tokenizer:
        def stream_tokens(self, text):
            for tok in text.split():
                yield tok

    a = Tokenizer.remote()
    toks = [
        ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S)
        for r in a.stream_tokens.options(num_returns="streaming").remote(
            "the quick brown fox"
        )
    ]
    assert toks == ["the", "quick", "brown", "fox"]
    ray_tpu_torch.kill(a)


def test_serve_handle_streaming(cluster):
    from ray_tpu_torch import serve

    serve.start(proxy=False)
    try:
        @serve.deployment
        class TokenGen:
            def __call__(self, prompt):
                for tok in f"echo {prompt}".split():
                    yield tok + " "

        handle = serve.run(TokenGen.bind(), name="tok", route_prefix=None)
        chunks = list(handle.options(stream=True).remote("hi there"))
        assert chunks == ["echo ", "hi ", "there "]
        serve.delete("tok")
    finally:
        serve.shutdown()


def test_serve_http_streams_partial_output_before_completion(cluster):
    """VERDICT round-2 item 3 'done' criterion: an HTTP client observes
    partial output while the handler is still producing."""
    import urllib.request

    from ray_tpu_torch import serve

    with socket.socket() as s:  # a free port: the reference's fixed one
        s.bind(("127.0.0.1", 0))  # would meet its own test's under xdist
        port = s.getsockname()[1]
    serve.start(serve.HTTPOptions(host="127.0.0.1", port=port))
    try:
        @serve.deployment
        async def slow_tokens(request):
            import asyncio as aio

            for i in range(5):
                yield f"tok{i} "
                await aio.sleep(0.4)

        serve.run(slow_tokens.bind(), name="stream_app", route_prefix="/")
        t0 = time.monotonic()
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30)
        first = resp.read(5)  # one chunk
        first_latency = time.monotonic() - t0
        assert first == b"tok0 "
        # Producer sleeps ~2s total after the first token; seeing it this
        # early proves the response streams rather than buffering.
        assert first_latency < 1.5, f"first chunk took {first_latency:.1f}s"
        rest = resp.read().decode()
        total_latency = time.monotonic() - t0
        assert rest == "tok1 tok2 tok3 tok4 "
        assert total_latency > first_latency + 1.0  # really was incremental
        serve.delete("stream_app")
    finally:
        serve.shutdown()


def test_stream_large_items_via_store(cluster):
    import numpy as np

    @ray_tpu_torch.remote(num_returns="streaming")
    def big_blocks(n):
        for i in range(n):
            yield np.full((300 * 1024,), i, dtype=np.uint8)  # > inline cap

    got = [ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S) for r in big_blocks.remote(3)]
    assert [int(g[0]) for g in got] == [0, 1, 2]
    assert all(len(g) == 300 * 1024 for g in got)
