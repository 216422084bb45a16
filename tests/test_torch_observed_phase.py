"""Phase 29 of chip_smoke.py rehearsed on the CPU at llama-tiny, and the
runtime's pieces it reads.

The rehearsal runs the phase's own code with a spec whose device is the
CPU: a num_gpus=1 actor with "compute" and "io" concurrency groups in a
STRICT_PACK placement group streams train steps whose losses are the
in-process ones bitwise (29a), answers io calls while the stream runs
(29b), holds the runtime's one (fake) GPU so that a task outside the
group stays pending and is cancelled, and gives it back when the group
is removed (29c), and shows in the runtime's own records what it did
(29d: the stream call's transitions and timeline, /metrics and a stack
profile). The checks that need the card (its name, the kernels'
launches) are listed by the phase instead of made, and the test holds
that list.

Beside it, the two things of the port's runtime the phase needs and the
reference lacks, each of which fails on the tree before them:
- `cancel(ref)` takes a task still queued at the head out of its queue,
  and its returns raise TaskCancelledError (the reference has no cancel);
- a streamed actor call records all seven task transitions: QUEUED where
  the head routes the call to its actor, and the execution span once the
  stream ends (before, a stream recorded no execution at all).

Every test has a deadline after which it fails instead of hanging, and
every `get` and `wait` a timeout.
"""
import os
import signal
import time

import pytest
import torch

import ray_tpu_torch

DEADLINE_S = 150
GET_TIMEOUT_S = 60
# The checks of 29a-29b that need the card, as the phase names them.
CARD_CHECKS = ["29a card", "29a card", "29a launches", "29b launches"]


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
def one_gpu(monkeypatch):
    """A runtime of 4 CPUs and one (fake) GPU."""
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "1")
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_phase_29_runs_at_llama_tiny_on_the_cpu(capsys, monkeypatch):
    from dataclasses import replace

    import chip_smoke as S
    from ray_tpu_torch.bench import bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "1")
    spec = S.surface_spec(model="llama-tiny", device="cpu", batch=2, seq=64, num_cpus=4)
    # Phase 5's losses, at the rehearsal's size: a warm-up and two steps.
    cfg = replace(CONFIGS["llama-tiny"], param_dtype=torch.bfloat16)
    in_process = bench_model(LlamaForCausalLM(cfg, device="cpu"), 2, 64, S.OBSERVED_STEPS - 1)
    out = S.phase_observed("the CPU (rehearsal)", in_process, spec)
    assert out["skipped"] == CARD_CHECKS
    readings = out["readings"]
    assert readings["losses"] == in_process["losses"][:S.OBSERVED_STEPS]
    assert readings["first_s"] < readings["end_s"]
    assert len(readings["io_ms"]) == S.OBSERVED_IO_CALLS
    printed = capsys.readouterr().out
    for line in ("29a:", "29b:", "29c:", "29d:"):
        assert line in printed and ": ok" in printed.split(line, 1)[1].splitlines()[0], printed
    # The actor held the runtime's one GPU.
    assert "CUDA_VISIBLE_DEVICES=0" in printed.split("29a:", 1)[1].splitlines()[0], printed


def test_cancel_takes_a_task_queued_at_the_head(one_gpu, tmp_path):
    from ray_tpu_torch.exceptions import TaskCancelledError

    started, release = tmp_path / "started", tmp_path / "release"

    @ray_tpu_torch.remote(num_gpus=1)
    def hold(started, release):
        open(started, "w").close()
        deadline = time.time() + GET_TIMEOUT_S
        while not os.path.exists(release) and time.time() < deadline:
            time.sleep(0.05)
        return "held"

    @ray_tpu_torch.remote(num_gpus=1)
    def queued():
        return "ran"

    holder = hold.remote(str(started), str(release))
    deadline = time.time() + GET_TIMEOUT_S
    while not started.exists():  # the holder runs, on the one GPU
        assert time.time() < deadline, "the holder never started"
        time.sleep(0.05)
    ref = queued.remote()
    ready, _ = ray_tpu_torch.wait([ref], timeout=1.0)
    assert not ready
    assert ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)
    assert not ray_tpu_torch.cancel(ref)  # gone from the queue
    # A task already running is left alone.
    assert not ray_tpu_torch.cancel(holder)
    release.touch()
    assert ray_tpu_torch.get(holder, timeout=GET_TIMEOUT_S) == "held"


def test_a_streamed_actor_call_records_all_seven_transitions(one_gpu):
    from ray_tpu_torch._private.events import TASK_PHASES, TASK_TRANSITIONS
    from ray_tpu_torch._private.state import task_transitions, timeline

    @ray_tpu_torch.remote
    class Counter:
        def count(self, n):
            for i in range(n):
                time.sleep(0.05)
                yield i

    actor = Counter.remote()
    stream = actor.count.options(num_returns="streaming").remote(3)
    assert [ray_tpu_torch.get(r, timeout=GET_TIMEOUT_S) for r in stream] == [0, 1, 2]
    tid = stream._task_id.hex()
    deadline = time.time() + 20
    names = []
    while time.time() < deadline:
        names = [e["event"] for e in task_transitions(tid)]
        if set(TASK_TRANSITIONS) <= set(names):
            break
        time.sleep(0.2)
    assert set(TASK_TRANSITIONS) <= set(names), names
    rows = [r for r in timeline() if r.get("cat") == "task_phase"
            and r["args"]["task_id"] == tid]
    assert [r["name"] for r in rows] == list(TASK_PHASES)
    # The execution phase spans the stream: three yields 50 ms apart.
    assert dict((r["name"], r["dur"]) for r in rows)["exec"] >= 0.1e6, rows


def test_a_call_to_a_dead_actor_is_not_recorded_as_queued(one_gpu):
    """The head records QUEUED only for a call it queues or dispatches: a
    call to a dead actor fails at the head and records none."""
    from ray_tpu_torch._private.state import list_cluster_events, task_transitions
    from ray_tpu_torch.exceptions import RayActorError

    @ray_tpu_torch.remote
    class Idle:
        def ping(self):
            return 1

    actor = Idle.remote()
    ray_tpu_torch.kill(actor)
    deadline = time.time() + 30
    while time.time() < deadline:
        ref = actor.ping.remote()
        try:
            ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)
        except RayActorError:
            break
        time.sleep(0.2)
    else:
        pytest.fail("the killed actor kept answering")
    # A return's id carries the first 12 bytes of its task's id.
    prefix = ref.id().hex()[:24]
    tids = set()
    while time.time() < deadline and not tids:
        tids = {e["entity"] for e in list_cluster_events(
            category="task", event="SUBMITTED", limit=10_000)
            if e["entity"].startswith(prefix)}
        time.sleep(0.2)
    assert len(tids) == 1, tids
    (tid,) = tids
    # The head records before it replies: a QUEUED would be in the ring
    # already; give the aggregator two more drains to show it.
    time.sleep(1.0)
    names = [e["event"] for e in task_transitions(tid)]
    assert "QUEUED" not in names, names
