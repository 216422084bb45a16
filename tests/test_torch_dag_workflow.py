"""The port's DAGs, compiled DAGs and workflows (`ray_tpu_torch.dag`,
`ray_tpu_torch.workflow`) against the reference's.

The 14 cases of tests/test_dag_workflow.py run on the port with the
reference's own thresholds (the compiled DAG at least 2x the RPC rate, the
two-stage pipeline at least 1.4x the sequential schedule). Then what is
the port's own: a llama-tiny compiled DAG of each runtime, the reference's
flax model and the port's with the same converted weights, held against
each other; torch tensors through a channel (they arrive as host tensors
of their dtype, shape and grad flag); the oversize payload's ValueError;
no `rtpt_` segment or semaphore left after `teardown()`; and each
runtime's workflow store kept apart from the other's.

One module-scoped cluster of each runtime (the reference's only where a
case needs it); every test has a deadline after which it fails instead of
hanging, and every `get` a timeout.
"""
import glob
import json
import os
import signal
import socket
import threading
import time
import urllib.request
from dataclasses import replace

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.dag import InputNode as RefInputNode
from ray_tpu_torch import workflow
from ray_tpu_torch._private.channel import PREFIX, Channel
from ray_tpu_torch.dag import InputNode

DEADLINE_S = 120
GET_TIMEOUT_S = 60
# Last-position logits of the two runtimes' llama-tiny (float32, the same
# converted weights): only the order of summation differs.
LLAMA_LOGITS_ATOL = 2e-5


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
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def both(cluster):
    """The reference's runtime beside the port's, as
    test_torch_runtime.py shows they can run in one process."""
    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu.shutdown()


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def mul(a, b):
    return a * b


def _get(ref):
    return ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)


def _shm_names(compiled):
    """The DAG's segments and semaphores as /dev/shm entries."""
    names = []
    for ch in compiled._all_channels:
        base = ch.name.strip("/")
        names += [f"/dev/shm/{base}", f"/dev/shm/sem.{base}.i", f"/dev/shm/sem.{base}.s"]
    return names


# ------------------------------------------------------------------- DAG
# tests/test_dag_workflow.py, case for case


def test_function_dag_execute(cluster):
    with InputNode() as inp:
        dag = add.bind(mul.bind(inp, 2), mul.bind(inp, 3))
    assert _get(dag.execute(10)) == 50  # 10*2 + 10*3


def test_dag_diamond_runs_once(cluster):
    @ray_tpu_torch.remote
    def tag(x):
        return (x, os.getpid(), time.time())

    @ray_tpu_torch.remote
    def first(t):
        return t[0]

    with InputNode() as inp:
        shared = tag.bind(inp)
        a = first.bind(shared)
        dag = add.bind(a, a)
    assert _get(dag.execute(21)) == 42


def test_compiled_dag_linear_chain(cluster):
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x + self.k

    s1, s2 = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        dag = s2.apply.bind(s1.apply.bind(inp))
    compiled = dag.experimental_compile()
    for i in range(20):
        assert compiled.execute(i) == i + 11
    compiled.teardown()
    # Actors still usable for normal calls after teardown.
    assert _get(s1.apply.remote(5)) == 6


def test_compiled_dag_faster_than_rpc(cluster):
    """Channel round-trips beat per-call task submission (reference:
    ~10x; the reference's test asserts >=2x, and so does this one)."""
    @ray_tpu_torch.remote
    class Echo:
        def apply(self, x):
            return x

    a = Echo.remote()
    _get(a.apply.remote(0))  # warm up worker
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        _get(a.apply.remote(i))
    rpc_s = time.perf_counter() - t0

    with InputNode() as inp:
        dag = a.apply.bind(inp)
    compiled = dag.experimental_compile()
    compiled.execute(0)  # warm
    t0 = time.perf_counter()
    for i in range(n):
        compiled.execute(i)
    chan_s = time.perf_counter() - t0
    compiled.teardown()
    assert chan_s * 2 < rpc_s, (
        f"compiled {chan_s * 1e6 / n:.0f}us/call vs rpc {rpc_s * 1e6 / n:.0f}us/call"
    )


def test_compiled_dag_error_propagation(cluster):
    @ray_tpu_torch.remote
    class Boom:
        def apply(self, x):
            if x == 13:
                raise ValueError("unlucky")
            return x

    a = Boom.remote()
    with InputNode() as inp:
        compiled = a.apply.bind(inp).experimental_compile()
    assert compiled.execute(1) == 1
    with pytest.raises(ValueError, match="unlucky"):
        compiled.execute(13)
    # Loop survives an error.
    assert compiled.execute(2) == 2
    compiled.teardown()


def test_compiled_dag_submit_collect_fifo(cluster):
    @ray_tpu_torch.remote
    class Working:
        def apply(self, x):
            if x == 3:
                raise ValueError("three")
            return x * 10

    a = Working.remote()
    with InputNode() as inp:
        compiled = a.apply.bind(inp).experimental_compile()
    for i in range(3):
        compiled.submit(i)
    assert compiled.collect() == 0
    assert compiled.collect() == 10
    compiled.submit(3)
    compiled.submit(4)
    assert compiled.collect() == 20
    with pytest.raises(ValueError, match="three"):
        compiled.collect()
    assert compiled.collect() == 40
    with pytest.raises(RuntimeError, match="matching submit"):
        compiled.collect()
    compiled.teardown()


def test_compiled_dag_two_stage_pipeline_overlaps(cluster):
    """Two stages in two actor processes overlap: sequential = 2*M*T,
    pipelined ~ (M+1)*T. The reference asserts >=1.4x (theory 1.78x at
    M=8), and so does this one."""
    stage_s = 0.08

    @ray_tpu_torch.remote
    class Stage:
        def apply(self, x):
            time.sleep(stage_s)
            return x + 1

    s1, s2 = Stage.remote(), Stage.remote()
    ray_tpu_torch.get([s1.apply.remote(0), s2.apply.remote(0)], timeout=GET_TIMEOUT_S)
    m = 8
    t0 = time.perf_counter()
    for i in range(m):
        _get(s2.apply.remote(_get(s1.apply.remote(i))))
    seq_s = time.perf_counter() - t0

    with InputNode() as inp:
        compiled = s2.apply.bind(s1.apply.bind(inp)).experimental_compile()
    compiled.execute(0)  # warm the resident loops
    t0 = time.perf_counter()
    feeder = threading.Thread(target=lambda: [compiled.submit(i) for i in range(m)])
    feeder.start()
    results = [compiled.collect() for _ in range(m)]
    feeder.join()
    pipe_s = time.perf_counter() - t0
    compiled.teardown()
    assert results == [i + 2 for i in range(m)]
    assert pipe_s * 1.4 < seq_s, (
        f"pipelined {pipe_s:.3f}s vs sequential {seq_s:.3f}s (speedup {seq_s / pipe_s:.2f}x)"
    )


# -------------------------------------------------------------- workflows


def test_workflow_run_and_output(cluster, tmp_path):
    workflow.init(str(tmp_path))
    out = workflow.run(add.bind(mul.bind(3, 4), 5), workflow_id="w1")
    assert out == 17
    assert workflow.get_status("w1") == "SUCCESSFUL"
    assert workflow.get_output("w1") == 17
    assert {"workflow_id": "w1", "status": "SUCCESSFUL"} in workflow.list_all()


def test_workflow_resume_skips_completed(cluster, tmp_path):
    workflow.init(str(tmp_path))
    marker = tmp_path / "count.txt"
    marker.write_text("0")

    @ray_tpu_torch.remote
    def counted(x):
        marker.write_text(str(int(marker.read_text()) + 1))
        return x + 100

    @ray_tpu_torch.remote
    def fail_once(x):
        if not (marker.parent / "healed").exists():
            raise RuntimeError("transient")
        return x * 2

    dag = fail_once.bind(counted.bind(1))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w2")
    assert workflow.get_status("w2") == "FAILED"
    assert marker.read_text() == "1"  # the first task ran and persisted

    (marker.parent / "healed").write_text("y")
    assert workflow.resume("w2") == 202
    assert marker.read_text() == "1"  # not re-executed on resume
    assert workflow.get_status("w2") == "SUCCESSFUL"


def test_workflow_run_async(cluster, tmp_path):
    workflow.init(str(tmp_path))

    @ray_tpu_torch.remote
    def slow(x):
        time.sleep(0.3)
        return x + 1

    fut = workflow.run_async(slow.bind(41), workflow_id="w3")
    assert fut.result(timeout=30) == 42


def test_workflow_delete(cluster, tmp_path):
    workflow.init(str(tmp_path))
    workflow.run(add.bind(1, 2), workflow_id="w4")
    workflow.delete("w4")
    assert workflow.get_status("w4") is None


def test_workflow_waits_for_posted_event(cluster, tmp_path):
    workflow.init(str(tmp_path / "wf_events"))

    @ray_tpu_torch.remote
    def consume(evt):
        return f"paid={evt['paid']} amount={evt['amount']}"

    node = consume.bind(workflow.wait_for_event("order/42", timeout_s=60))
    fut = workflow.run_async(node, workflow_id="order-42")
    time.sleep(0.5)
    assert not fut.done()  # genuinely waiting, not racing through
    workflow.post_event("order/42", {"paid": True, "amount": 7})
    assert fut.result(timeout=60) == "paid=True amount=7"
    # Durable: the completed wait node persisted; resume re-delivers
    # without re-waiting.
    assert workflow.resume("order-42") == "paid=True amount=7"


def test_workflow_event_over_http(cluster, tmp_path):
    """The HTTP provider: POST to the port's dashboard fires the event."""
    pytest.importorskip("aiohttp")
    from ray_tpu_torch.dashboard import start_dashboard

    workflow.init(str(tmp_path / "wf_http"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = start_dashboard(port=port)

    @ray_tpu_torch.remote
    def consume(evt):
        return evt["source"]

    fut = workflow.run_async(
        consume.bind(workflow.wait_for_event("deploy/done", timeout_s=60)),
        workflow_id="http-evt",
    )
    req = urllib.request.Request(
        f"{url}/api/workflow/events/deploy/done", method="POST",
        data=json.dumps({"source": "ci-pipeline"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["ok"]
    assert fut.result(timeout=60) == "ci-pipeline"


def test_workflow_event_timeout(cluster, tmp_path):
    workflow.init(str(tmp_path / "wf_timeout"))
    node = workflow.wait_for_event("never/fires", timeout_s=1.0)
    with pytest.raises(Exception, match="not posted within"):
        workflow.run(node, workflow_id="evt-timeout")


# ------------------------------------------------- llama-tiny, both runtimes


def _llama_pair():
    """The reference's flax llama-tiny (float32) and its weights converted
    for the port's; ids from numpy seeds."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jllama
    from ray_tpu_torch.convert import llama_params_from_flax

    jcfg = replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32)
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    state = llama_params_from_flax(params)
    return jax.tree.map(np.asarray, params), state


@ray_tpu.remote
class JaxLlamaStage:
    def __init__(self, params):
        import jax.numpy as jnp

        from ray_tpu.models import llama as jllama

        self.model = jllama.LlamaForCausalLM(
            replace(jllama.CONFIGS["llama-tiny"], dtype=jnp.float32))
        self.params = params

    def forward(self, ids):
        import jax.numpy as jnp

        return np.asarray(self.model.apply(self.params, jnp.asarray(ids)[None]))[0, -1]


@ray_tpu_torch.remote
class TorchLlamaStage:
    def __init__(self, state):
        from ray_tpu_torch.models import llama as tllama

        self.model = tllama.LlamaForCausalLM(
            replace(tllama.CONFIGS["llama-tiny"], dtype=torch.float32), device="cpu")
        self.model.load_state_dict(state)

    def forward(self, ids):
        with torch.inference_mode():
            return self.model(torch.as_tensor(ids, dtype=torch.long)[None])[0, -1]


def _argmax_stage(remote):
    @remote
    class Argmax:
        def apply(self, logits):
            return logits, int(np.argmax(np.asarray(logits)))

    return Argmax


def test_llama_tiny_compiled_dag_matches_the_references(both):
    params, state = _llama_pair()
    rng = np.random.RandomState(0)
    requests = [rng.randint(0, 512, n).astype(np.int32) for n in (16, 48, 16, 48)]
    got = {}
    for name, rt, stage in (("ray_tpu", ray_tpu, JaxLlamaStage.remote(params)),
                            ("ray_tpu_torch", ray_tpu_torch, TorchLlamaStage.remote(state))):
        argmax = _argmax_stage(rt.remote).remote()
        with (RefInputNode() if name == "ray_tpu" else InputNode()) as inp:
            compiled = argmax.apply.bind(stage.forward.bind(inp)).experimental_compile()
        try:
            got[name] = [compiled.execute(r) for r in requests]
        finally:
            compiled.teardown()
    for (want, want_tok), (logits, tok) in zip(got["ray_tpu"], got["ray_tpu_torch"]):
        assert isinstance(logits, torch.Tensor) and logits.dtype == torch.float32
        assert logits.shape == (512,) and logits.device.type == "cpu"
        np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=LLAMA_LOGITS_ATOL)
        assert tok == want_tok


# ----------------------------------------------------------- channels


def test_bf16_grad_tensor_through_a_channel_and_a_compiled_dag(cluster):
    t = torch.randn(33, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    t.requires_grad_(True)
    ch = Channel()
    try:
        ch.write(("ok", t), timeout=5)
        status, back = ch.read(timeout=5)
    finally:
        ch.destroy()
    assert status == "ok"
    assert back.dtype == torch.bfloat16 and back.shape == t.shape and back.requires_grad
    assert torch.equal(back.detach(), t.detach())
    # numpy values come back writable, as from the reference's pickle.
    ch = Channel()
    try:
        ch.write(np.arange(40_000.0), timeout=5)
        arr = ch.read(timeout=5)
    finally:
        ch.destroy()
    arr[0] = -1.0
    assert arr.flags.writeable and arr[1] == 1.0

    @ray_tpu_torch.remote
    class Describe:
        def apply(self, x):
            return x, (str(x.dtype), tuple(x.shape), x.requires_grad, x.device.type)

    with InputNode() as inp:
        compiled = Describe.remote().apply.bind(inp).experimental_compile()
    try:
        back, seen = compiled.execute(t)
    finally:
        compiled.teardown()
    assert seen == ("torch.bfloat16", (33, 7), True, "cpu")
    assert back.dtype == torch.bfloat16 and back.requires_grad and torch.equal(back.detach(), t.detach())


def test_oversize_payload_raises_the_references_value_error(cluster):
    big = np.zeros(2 << 20, dtype=np.uint8)
    ch = Channel()
    try:
        assert ch.capacity == 1 << 20  # the reference's capacity
        with pytest.raises(ValueError, match="exceeds channel capacity"):
            ch.write(big, timeout=5)
    finally:
        ch.destroy()

    @ray_tpu_torch.remote
    class Grow:
        def apply(self, n):
            return torch.zeros(n, dtype=torch.uint8)

    with InputNode() as inp:
        compiled = Grow.remote().apply.bind(inp).experimental_compile()
    try:
        with pytest.raises(ValueError, match="exceeds channel capacity"):
            compiled.execute(2 << 20)  # the stage's output is too big
        assert compiled.execute(8).shape == (8,)  # and the loop goes on
    finally:
        compiled.teardown()


def test_teardown_leaves_no_segment_or_semaphore(cluster):
    @ray_tpu_torch.remote
    class Stage:
        def apply(self, x):
            return x + 1

    s1, s2 = Stage.remote(), Stage.remote()
    with InputNode() as inp:
        compiled = s2.apply.bind(s1.apply.bind(inp)).experimental_compile()
    assert compiled.execute(1) == 3
    names = _shm_names(compiled)
    assert len(names) == 9 and all(os.path.basename(n).removeprefix("sem.").startswith(PREFIX)
                                   for n in names)
    assert all(os.path.exists(n) for n in names), [n for n in names if not os.path.exists(n)]
    compiled.teardown()
    assert not [n for n in names if os.path.exists(n)]
    # None of the reference's default names: no psm_ segment of ours.
    assert not any(os.path.basename(n).startswith("psm_") for n in names)


# ------------------------------------------------------- stores kept apart


def test_each_runtimes_workflow_store_is_its_own(both, tmp_path, monkeypatch):
    import ray_tpu.workflow as ref_workflow
    import ray_tpu.workflow.api as ref_api
    import ray_tpu_torch.workflow.api as port_api
    from ray_tpu.workflow import storage as ref_storage
    from ray_tpu_torch.workflow import storage as port_storage

    assert port_storage.DEFAULT_STORAGE != ref_storage.DEFAULT_STORAGE
    assert port_storage.DEFAULT_STORAGE.endswith(os.path.join(".ray_tpu_torch", "workflows"))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", str(ref_dir))
    monkeypatch.setenv("RAY_TPU_TORCH_WORKFLOW_STORAGE", str(port_dir))
    monkeypatch.setattr(ref_api, "_storage", None)
    monkeypatch.setattr(port_api, "_storage", None)

    @ray_tpu.remote
    def ref_value():
        return "reference"

    @ray_tpu_torch.remote
    def port_value():
        return torch.arange(4, dtype=torch.bfloat16)

    # The port first: the reference's store stays untouched.
    out = workflow.run(port_value.bind(), workflow_id="same-id")
    assert torch.equal(out, torch.arange(4, dtype=torch.bfloat16))
    assert os.listdir(port_dir) == ["same-id"] and not ref_dir.exists()
    # Then the reference, with the same id: the port's store stays as it was.
    before = sorted(glob.glob(str(port_dir / "**"), recursive=True))
    assert ref_workflow.run(ref_value.bind(), workflow_id="same-id") == "reference"
    assert os.listdir(ref_dir) == ["same-id"]
    assert sorted(glob.glob(str(port_dir / "**"), recursive=True)) == before
    # Each resume reads its own results.
    back = workflow.resume("same-id")
    assert back.dtype == torch.bfloat16 and torch.equal(back, out)
    assert ref_workflow.resume("same-id") == "reference"
