"""The port's Serve (`ray_tpu_torch.serve`) against the reference's
(`ray_tpu.serve`).

tests/test_serve.py's 11 cases and tests/test_serve_grpc_yaml.py's 2 run
through each module on its own runtime (both at once in this process,
one module-scoped cluster of each, 8 CPUs apiece), with the reference's
assertions. Each runtime binds its own HTTP port, a free one picked at
the test's start (the reference's files bind 18099 and 8000, the YAML
case's default); gRPC binds port 0, as the reference's file does, and
reads the bound port back.

Then a llama-tiny `@serve.batch` deployment on each runtime: the flax
model in the reference's replica, the port's model in the port's
replica with the same weights through `llama_params_from_flax`, both in
float32. The same ragged requests go to both at once; every response's
last-position logits agree within tests/test_torch_llama.py's float32
tolerance and give the same next token.

Every test has a deadline after which it fails instead of hanging, and
every `result()` a timeout.
"""
import asyncio
import importlib
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
from dataclasses import replace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

DEADLINE_S = 150
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
NAMES = sorted(RUNTIMES)
# tests/test_torch_llama.py's float32 tolerance: summation order only.
F32_TOL = 1e-4
# The port against itself: the same float32 arithmetic, summation order aside.
SELF_TOL = 1e-5
# Each handle's router pushes metrics from a daemon thread. The port's
# `serve.shutdown()` ends and joins these threads. The reference's run
# on until they find their runtime shut down (`Router._push_metrics_loop`),
# so the module's teardown waits for those: none may live on into the
# session of a later test file in this process, where its pushes would
# add owned objects to that session's counts.
_REFERENCE_ROUTER_THREADS = []
ROUTER_JOIN_S = 30


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
def clusters():
    ray_tpu.init(num_cpus=8, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=8, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    for thread in _REFERENCE_ROUTER_THREADS:
        thread.join(timeout=ROUTER_JOIN_S)


def _serve(name):
    return importlib.import_module(f"{name}.serve")


def _router_threads(name):
    routers = importlib.import_module(f"{name}.serve._private.router")._routers
    return [r._metrics_thread for r in routers.values()]


def _shutdown(name):
    """`serve.shutdown()`, keeping the reference's router metrics threads
    to join."""
    if name == "ray_tpu":
        _REFERENCE_ROUTER_THREADS.extend(_router_threads(name))
    _serve(name).shutdown()


@pytest.fixture
def session(clusters, name):
    """tests/test_serve_grpc_yaml.py's `serve_session`: the cluster; Serve
    is shut down after the test."""
    yield _serve(name)
    _shutdown(name)


@pytest.fixture
def serve_session(session):
    """tests/test_serve.py's `serve_session`: Serve without a proxy."""
    session.start(proxy=False)
    return session


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def serve_session_http(session):
    """tests/test_serve.py's `serve_session_http`, on a port of its own."""
    port = _free_port()
    session.start(session.HTTPOptions(host="127.0.0.1", port=port))
    return session, port


# ------------------------------------------------------- tests/test_serve.py


@pytest.mark.parametrize("name", NAMES)
def test_function_deployment(serve_session):
    serve = serve_session

    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="fn_app", route_prefix=None)
    assert handle.remote(21).result(timeout_s=10) == 42
    serve.delete("fn_app")


@pytest.mark.parametrize("name", NAMES)
def test_class_deployment_and_methods(serve_session):
    serve = serve_session

    @serve.deployment
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting

        def __call__(self, name):
            return f"{self.greeting}, {name}!"

        def shout(self, name):
            return f"{self.greeting.upper()} {name.upper()}"

    handle = serve.run(Greeter.bind("hello"), name="greet", route_prefix=None)
    assert handle.remote("world").result(timeout_s=10) == "hello, world!"
    assert handle.shout.remote("world").result(timeout_s=10) == "HELLO WORLD"
    serve.delete("greet")


@pytest.mark.parametrize("name", NAMES)
def test_composition(serve_session):
    serve = serve_session

    @serve.deployment
    class Adder:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @serve.deployment
    class Combiner:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        async def __call__(self, x):
            return await self.a.remote(x) + await self.b.remote(x)

    app = Combiner.bind(Adder.options(name="A1").bind(1), Adder.options(name="A2").bind(2))
    handle = serve.run(app, name="comp", route_prefix=None)
    # (x+1) + (x+2) = 2x+3
    assert handle.remote(10).result(timeout_s=10) == 23
    serve.delete("comp")


@pytest.mark.parametrize("name", NAMES)
def test_multiple_replicas_spread(serve_session):
    serve = serve_session

    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __call__(self, _):
            return serve.get_replica_context().replica_id

    handle = serve.run(WhoAmI.bind(), name="spread", route_prefix=None)
    ids = {handle.remote(i).result(timeout_s=10) for i in range(30)}
    assert len(ids) >= 2, f"expected requests on >=2 replicas, saw {ids}"
    serve.delete("spread")


@pytest.mark.parametrize("name", NAMES)
def test_status_and_redeploy_reconfigure(serve_session):
    serve = serve_session

    @serve.deployment(user_config={"factor": 2})
    class Scaler:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return x * self.factor

    handle = serve.run(Scaler.bind(), name="cfg", route_prefix=None)
    assert handle.remote(10).result(timeout_s=10) == 20
    statuses = serve.status()
    assert statuses["cfg"].status.value == "RUNNING"
    assert statuses["cfg"].deployments["Scaler"].num_replicas == 1

    # Redeploy with a new user_config: reconfigured in place.
    handle = serve.run(
        Scaler.options(user_config={"factor": 5}).bind(), name="cfg",
        route_prefix=None,
    )
    deadline = time.time() + 15
    while time.time() < deadline:
        if handle.remote(10).result(timeout_s=10) == 50:
            break
        time.sleep(0.1)
    assert handle.remote(10).result(timeout_s=10) == 50
    serve.delete("cfg")


@pytest.mark.parametrize("name", NAMES)
def test_autoscaling_up_and_down(serve_session):
    serve = serve_session

    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1,
            max_replicas=3,
            target_ongoing_requests=1,
            upscale_delay_s=0.2,
            downscale_delay_s=1.0,
            metrics_interval_s=0.1,
            look_back_period_s=1.0,
        ),
        max_ongoing_requests=2,
    )
    class Slow:
        async def __call__(self, _):
            await asyncio.sleep(0.4)
            return serve.get_replica_context().replica_id

    handle = serve.run(Slow.bind(), name="auto", route_prefix=None)
    # Flood with concurrent requests to force upscale.
    responses = [handle.remote(i) for i in range(40)]
    ids = {r.result(timeout_s=60) for r in responses}
    assert len(ids) >= 2, f"expected autoscale to >=2 replicas, saw {len(ids)}"
    # Idle: scale back down to min_replicas.
    deadline = time.time() + 30
    while time.time() < deadline:
        info = serve.status()["auto"].deployments["Slow"]
        if info.num_replicas == 1:
            break
        time.sleep(0.25)
    assert serve.status()["auto"].deployments["Slow"].num_replicas == 1
    serve.delete("auto")


@pytest.mark.parametrize("name", NAMES)
def test_http_proxy(serve_session_http):
    serve, port = serve_session_http

    @serve.deployment
    class Echo:
        def __call__(self, request):
            if request.path.endswith("/sum"):
                data = request.json()
                return {"sum": sum(data["values"])}
            return "hello http"

    serve.run(Echo.bind(), name="web", route_prefix="/")
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(f"{base}/", timeout=30) as resp:
        assert resp.read().decode() == "hello http"
    req = urllib.request.Request(
        f"{base}/sum", data=json.dumps({"values": [1, 2, 3]}).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"sum": 6}
    with urllib.request.urlopen(f"{base}/-/routes", timeout=30) as resp:
        assert json.loads(resp.read()) == {"/": "web"}
    serve.delete("web")


@pytest.mark.parametrize("name", NAMES)
def test_shutdown_ends_the_routers_metrics_threads_on_the_port_only(session, name):
    """The departure, pinned: after `serve.shutdown()` the port's router
    metrics threads have ended; the reference's push on to the controller
    of a Serve that is gone, for as long as their runtime lives."""
    serve = session
    serve.start(proxy=False)

    @serve.deployment
    def echo(x):
        return x

    handle = serve.run(echo.bind(), name="metrics_app", route_prefix=None)
    assert handle.remote(7).result(timeout_s=10) == 7
    threads = _router_threads(name)
    assert threads and all(t.is_alive() for t in threads)
    _shutdown(name)
    alive = [t.is_alive() for t in threads]
    assert alive == [name == "ray_tpu"] * len(threads)
    session.start(proxy=False)  # for the fixture's own shutdown


@pytest.mark.parametrize("name", NAMES)
def test_batching(serve_session):
    serve = serve_session

    @serve.deployment
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def handle_batch(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 10 for x in xs]

        async def __call__(self, x):
            return await self.handle_batch(x)

        def seen_batches(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind(), name="batch", route_prefix=None)
    responses = [handle.remote(i) for i in range(16)]
    assert [r.result(timeout_s=20) for r in responses] == [i * 10 for i in range(16)]
    sizes = handle.seen_batches.remote().result(timeout_s=10)
    assert max(sizes) > 1, f"batching never coalesced: {sizes}"
    serve.delete("batch")


@pytest.mark.parametrize("name", NAMES)
def test_multiplexed_models(serve_session):
    serve = serve_session

    @serve.deployment
    class MuxModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return {"id": model_id, "loaded_at": time.time()}

        async def __call__(self, _):
            model_id = serve.get_multiplexed_model_id()
            model = await self.get_model(model_id)
            return model["id"]

    handle = serve.run(MuxModel.bind(), name="mux", route_prefix=None)
    assert (
        handle.options(multiplexed_model_id="m1").remote(None).result(timeout_s=10)
        == "m1"
    )
    assert (
        handle.options(multiplexed_model_id="m2").remote(None).result(timeout_s=10)
        == "m2"
    )
    serve.delete("mux")


@pytest.mark.parametrize("name", NAMES)
def test_failing_deployment_reports_deploy_failed(serve_session):
    """A crash-looping constructor surfaces DEPLOY_FAILED instead of
    hanging serve.run until timeout."""
    serve = serve_session

    @serve.deployment
    class Broken:
        def __init__(self):
            raise RuntimeError("boom at init")

        def __call__(self, x):
            return x

    with pytest.raises(RuntimeError, match="Deploy failed"):
        serve.run(Broken.bind(), name="broken", route_prefix=None,
                  timeout_s=60)
    serve.delete("broken")


@pytest.mark.parametrize("name", NAMES)
def test_replica_recovery_after_kill(serve_session):
    serve = serve_session

    @serve.deployment(health_check_period_s=0.2)
    class Sturdy:
        def __call__(self, x):
            return x + 1

        def pid(self):
            import os

            return os.getpid()

    handle = serve.run(Sturdy.bind(), name="sturdy", route_prefix=None)
    assert handle.remote(1).result(timeout_s=10) == 2
    pid = handle.pid.remote().result(timeout_s=10)
    # Kill the replica's worker process out from under Serve.
    os.kill(pid, signal.SIGKILL)
    # The controller's health checks replace the replica; requests keep
    # succeeding (routed around the dead replica, retried).
    deadline = time.time() + 40
    ok = False
    while time.time() < deadline:
        try:
            if handle.remote(5).result(timeout_s=10) == 6:
                new_pid = handle.pid.remote().result(timeout_s=10)
                if new_pid != pid:
                    ok = True
                    break
        except Exception:
            time.sleep(0.2)
    assert ok, "replica was not replaced after SIGKILL"
    serve.delete("sturdy")


# ----------------------------------------------- tests/test_serve_grpc_yaml.py


@pytest.mark.parametrize("name", NAMES)
def test_grpc_ingress_roundtrip(session, name):
    import grpc

    serve = session
    runtime = RUNTIMES[name]
    serve.start(
        proxy=False, grpc_options=serve.GRPCOptions(host="127.0.0.1", port=0)
    )
    # Port 0: read the bound port back from the proxy actor.
    grpc_actor = runtime.get_actor("SERVE_PROXY::grpc")
    addr = runtime.get(grpc_actor.ready.remote(), timeout=30)

    @serve.deployment
    class Scorer:
        def __call__(self, x):
            return {"score": x * 2}

        def describe(self):
            return "scorer-v1"

    serve.run(Scorer.bind(), name="scoring", route_prefix=None)

    channel = grpc.insecure_channel(addr)
    call = channel.unary_unary("/scoring/__call__")
    reply = pickle.loads(call(pickle.dumps(((21,), {})), timeout=30))
    assert reply == {"score": 42}

    # Method routing via the path.
    describe = channel.unary_unary("/scoring/describe")
    assert pickle.loads(describe(pickle.dumps(((), {})), timeout=30)) == "scorer-v1"

    # Metadata-based routing with an arbitrary method path.
    generic = channel.unary_unary(f"/{name}.serve.Serve/Call")
    reply = pickle.loads(
        generic(
            pickle.dumps(((5,), {})),
            metadata=(("application", "scoring"),),
            timeout=30,
        )
    )
    assert reply == {"score": 10}

    # Unknown app -> NOT_FOUND.
    with pytest.raises(grpc.RpcError) as err:
        channel.unary_unary("/nope/__call__")(pickle.dumps(((), {})), timeout=30)
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
    channel.close()
    serve.delete("scoring")


@pytest.mark.parametrize("name", NAMES)
def test_yaml_deploy_and_zero_downtime_rescale(serve_session_http, name, tmp_path):
    # Serve started first, with its proxy on a free port: `deploy_config`
    # would start it on the default port 8000, which the reference's own
    # file binds in a parallel worker.
    serve, _ = serve_session_http
    # An importable module holding the bound application; one module
    # name per runtime, since this process imports both.
    module = f"echo_app_mod_{name}"
    mod = tmp_path / f"{module}.py"
    mod.write_text(
        textwrap.dedent(
            f"""
            from {name} import serve

            @serve.deployment
            class Echo:
                def __call__(self, x):
                    return f"echo:{{x}}"

            app = Echo.bind()
            """
        )
    )
    sys.path.insert(0, str(tmp_path))
    try:
        config = tmp_path / "serve_config.yaml"
        config.write_text(
            textwrap.dedent(
                f"""
                applications:
                  - name: echo
                    route_prefix: null
                    import_path: {module}:app
                    deployments:
                      - name: Echo
                        num_replicas: 1
                """
            )
        )
        serve.deploy_config(str(config))
        handle = serve.get_app_handle("echo")
        assert handle.remote("a").result(timeout_s=30) == "echo:a"
        statuses = serve.status()
        assert statuses["echo"].deployments["Echo"].num_replicas == 1

        # Redeploy with 2 replicas; requests keep succeeding throughout.
        config.write_text(
            config.read_text().replace("num_replicas: 1", "num_replicas: 2")
        )
        stop = threading.Event()
        failures = []

        def hammer():
            i = 0
            while not stop.is_set():
                try:
                    r = handle.remote(i).result(timeout_s=30)
                    assert r == f"echo:{i}"
                except Exception as e:  # noqa: BLE001
                    failures.append(e)
                i += 1
                time.sleep(0.05)

        t = threading.Thread(target=hammer)
        t.start()
        try:
            serve.deploy_config(str(config))
            deadline = time.time() + 60
            while time.time() < deadline:
                if serve.status()["echo"].deployments["Echo"].num_replicas == 2:
                    break
                time.sleep(0.2)
            assert (
                serve.status()["echo"].deployments["Echo"].num_replicas == 2
            ), "rescale to 2 replicas never happened"
        finally:
            stop.set()
            t.join(timeout=30)
        assert not failures, f"requests failed during redeploy: {failures[:3]}"
        serve.delete("echo")
    finally:
        sys.path.remove(str(tmp_path))


# ------------------------------------------------------------ the port's own


def test_import_pulls_in_no_proxy_library_and_nothing_of_the_reference():
    """aiohttp, grpc and yaml stay lazy (the card's machine has none of
    them): importing Serve, and starting it without a proxy, loads none."""
    code = textwrap.dedent("""
        import sys
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve
        rt.init(num_cpus=2)
        try:
            serve.start(proxy=False)

            @serve.deployment
            def double(x):
                return x * 2

            assert serve.run(double.bind(), name="d", route_prefix=None).remote(4).result(
                timeout_s=30) == 8
        finally:
            serve.shutdown()
            rt.shutdown()
        print(sorted(m for m in sys.modules if m.split('.')[0] in
                     ('ray_tpu', 'jax', 'flax', 'optax', 'aiohttp', 'grpc', 'yaml')))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=DEADLINE_S - 30, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _llama_app(serve, name, weights):
    """A llama-tiny deployment whose `@serve.batch` method right-pads a
    batch of token-id lists and returns each one's last real position's
    float32 logits: the flax model on the reference, the port's on the
    port. Imports live in the methods, so the port's replica never
    imports jax."""

    @serve.deployment(name="TinyLlama")
    class TinyLlama:
        def __init__(self, weights):
            if name == "ray_tpu":
                import jax
                import jax.numpy as jnp
                from ray_tpu.models import llama

                cfg = replace(llama.CONFIGS["llama-tiny"], dtype=jnp.float32)
                model = llama.LlamaForCausalLM(cfg)
                params = jax.tree.map(jnp.asarray, weights)
                forward = jax.jit(model.apply)
                self._logits = lambda ids: np.asarray(forward(params, jnp.asarray(ids)))
            else:
                import torch
                from ray_tpu_torch.models import llama

                cfg = replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32)
                model = llama.LlamaForCausalLM(cfg, device="cpu")
                model.load_state_dict(weights)

                def logits(ids):
                    with torch.inference_mode():
                        return model(torch.from_numpy(ids).long()).numpy()

                self._logits = logits
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def forward(self, requests):
            self.batch_sizes.append(len(requests))
            ids = np.zeros((len(requests), max(map(len, requests))), np.int32)
            for i, r in enumerate(requests):
                ids[i, :len(r)] = r
            logits = self._logits(ids)
            return [logits[i, len(r) - 1].astype(np.float32) for i, r in enumerate(requests)]

        async def __call__(self, ids):
            return await self.forward(ids)

        def seen_batches(self):
            return self.batch_sizes

    return TinyLlama.bind(weights)


def test_llama_tiny_batched_deployment_gives_the_references_logits(clusters):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.convert import llama_params_from_flax

    cfg = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)
    params = jllama.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))
    weights = {"ray_tpu": jax.tree.map(np.asarray, params),
               "ray_tpu_torch": llama_params_from_flax(params)}
    lengths = np.random.RandomState(0).randint(8, 49, 12)
    ids_rng = np.random.RandomState(1)
    requests = [ids_rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    handles, responses, sizes = {}, {}, {}
    try:
        for name in NAMES:
            serve = _serve(name)
            serve.start(proxy=False)
            handles[name] = serve.run(_llama_app(serve, name, weights[name]),
                                      name="llama", route_prefix=None, timeout_s=120)
        # Both runtimes' requests are in flight at once.
        pending = {name: [h.remote(r) for r in requests] for name, h in handles.items()}
        for name, rs in pending.items():
            responses[name] = [r.result(timeout_s=120) for r in rs]
            sizes[name] = handles[name].seen_batches.remote().result(timeout_s=30)
    finally:
        for name in NAMES:
            _shutdown(name)
    for name in NAMES:
        assert sum(sizes[name]) == len(requests) and max(sizes[name]) > 1, (name, sizes)
    for i, (want, got) in enumerate(zip(responses["ray_tpu"], responses["ray_tpu_torch"])):
        assert got.dtype == np.float32 and got.shape == (cfg.vocab_size,)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL, err_msg=f"request {i}")
        assert int(got.argmax()) == int(want.argmax()), i


def test_llama_tiny_batched_responses_are_each_requests_answer_alone(clusters):
    """Each response of the port's batched llama-tiny deployment, whatever
    batch the request lands in, is its request's logits computed alone
    (in this process, the same float32 weights) within 1e-5: right
    padding changes no real position's answer beyond summation order.
    (In one process both runtimes' batched rows read within 3.5e-6 of
    their rows alone, so a batch that formed differently under load does
    not explain a reading of 3.9e-4 between the runtimes; ROADMAP.md.)"""
    import torch

    from ray_tpu_torch.models import llama as tllama

    cfg = replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")  # seed 0
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    lengths = np.random.RandomState(3).randint(8, 49, 12)
    ids_rng = np.random.RandomState(4)
    requests = [ids_rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    serve = _serve("ray_tpu_torch")
    try:
        serve.start(proxy=False)
        handle = serve.run(_llama_app(serve, "ray_tpu_torch", weights), name="llama_alone",
                           route_prefix=None, timeout_s=120)
        pending = [handle.remote(r) for r in requests]
        responses = [r.result(timeout_s=120) for r in pending]
        sizes = handle.seen_batches.remote().result(timeout_s=30)
    finally:
        _shutdown("ray_tpu_torch")
    assert sum(sizes) == len(requests) and max(sizes) > 1, sizes
    for i, (r, got) in enumerate(zip(requests, responses)):
        with torch.inference_mode():
            want = model(torch.tensor([r])).numpy()[0, -1]
        np.testing.assert_allclose(got, want, atol=SELF_TOL, rtol=SELF_TOL, err_msg=f"request {i}")
