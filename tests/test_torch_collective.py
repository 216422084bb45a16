"""The port's out-of-graph collectives (`ray_tpu_torch.util.collective`)
against the reference's (`ray_tpu.util.collective`).

tests/test_collective.py's cases on both runtimes, and on the port with
its ranks as tasks, as the reference's file runs them (on leased
workers, where the reference's submitter can queue one rank behind
another and hang); then every op of
groups of 2 and 3 actors on inputs made from a seed: numpy inputs give
what the reference gives, bit for bit; bfloat16 and float32 tensors give
tensors of their dtype on their device, equal to torch's own reduction
of the same inputs on the host. Last, phase 20's layout of
`chip_smoke.py` on a node faked to one GPU: two `num_gpus=0.5` actors
share the card and run the ops between them. Last, leaving a group: the
port's coordinator lives until the last member has left (the reference's
rank 0 ends it on its own return, under the others' replies), and exits
on its own once its leave timeout has passed.

Both runtimes run at once in this process (one module-scoped cluster of
each, 4 CPUs apiece); every test has a deadline, and every `get` a
timeout.
"""
import importlib
import os
import signal

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.util.collective.collective import _GroupCoordinator as _PortCoordinator

DEADLINE_S = 120
GET_TIMEOUT_S = 60
RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
REDUCE_OPS = ("sum", "mean", "max", "min", "product")
ROUNDS_AT_ONCE = 8
# _SlowReplies holds the replies of every rank but 0 this long.
REPLY_DELAY_S = 1.0
# _SlowLeave answers a leave this late.
LEAVE_DELAY_S = 2.0
TORCH_REDUCE = {
    "sum": lambda s: s.sum(0), "mean": lambda s: s.mean(0), "max": lambda s: s.amax(0),
    "min": lambda s: s.amin(0), "product": lambda s: s.prod(0),
}


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
    """Both runtimes; the port's node faked to one GPU (phase 20's layout)."""
    old = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "1"
    try:
        ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
        if old is None:
            os.environ.pop("RAY_TPU_TORCH_NUM_GPUS", None)
        else:
            os.environ["RAY_TPU_TORCH_NUM_GPUS"] = old


def _collective(runtime):
    return importlib.import_module(f"{runtime}.util.collective")


# ----------------------------------------------- tests/test_collective.py


class _Rank:
    """One member of every group: an actor, so that the members of a
    group run at once. A group of tasks can deadlock on the reference's
    runtime: its submitter may queue one rank's task behind another's on
    the same leased worker, where that one blocks in the collective
    forever (the port's cases of tasks are below)."""

    def __init__(self, runtime):
        self.rt = importlib.import_module(runtime)
        self.col = _collective(runtime)

    def mirror(self, group, rank, world, value):
        col = self.col
        col.init_collective_group(world, rank, group_name=group)
        reduced = col.allreduce(np.full((4,), value, np.float32), group_name=group)
        gathered = col.allgather(np.array([rank], np.int32), group_name=group)
        bcast = col.broadcast(np.array([42.0]) if rank == 0 else None, src_rank=0,
                              group_name=group)
        col.barrier(group_name=group)
        shard = col.reducescatter(np.arange(4, dtype=np.float32) * (rank + 1), group_name=group)
        return reduced.tolist(), [int(x[0]) for x in gathered], float(bcast[0]), shard.tolist()

    def call_at(self, actor, at):
        """Four calls of `actor.loop` from this process, sent at `at`."""
        import time

        time.sleep(max(0.0, at - time.time()))
        refs = [actor.loop.remote() for _ in range(4)]
        return self.rt.get(refs, timeout=GET_TIMEOUT_S)

    def every_op(self, group, rank, world, kind, seed):
        col = self.col
        x = _input(rank, seed, kind)
        col.init_collective_group(world, rank, group_name=group)
        out = {f"allreduce_{op}": col.allreduce(x, group_name=group, op=op) for op in REDUCE_OPS}
        out["allgather"] = col.allgather(x, group_name=group)
        out["reducescatter"] = col.reducescatter(x, group_name=group)
        out["broadcast"] = col.broadcast(x, src_rank=world - 1, group_name=group)
        out["broadcast_none"] = col.broadcast(x if rank == 0 else None, src_rank=0,
                                              group_name=group)
        col.barrier(group_name=group)
        return out

    def leave(self, group):
        self.col.destroy_collective_group(group)

    def leave_within(self, group, seconds):
        """Leave, waiting at most `seconds` for the coordinator's answer:
        (whether it raised, how long it took)."""
        import time

        module = self.col.collective
        old, module.LEAVE_TIMEOUT_S = module.LEAVE_TIMEOUT_S, seconds
        t0 = time.monotonic()
        try:
            self.col.destroy_collective_group(group)
            raised = None
        except Exception as e:  # noqa: BLE001
            raised = type(e).__name__
        finally:
            module.LEAVE_TIMEOUT_S = old
        return raised, time.monotonic() - t0

    def join(self, group, rank, world):
        self.col.init_collective_group(world, rank, group_name=group)
        self.col.barrier(group_name=group)

    def reduce_and_leave(self, group, rank, world):
        """One allreduce, then leave at once: (the result, when its reply
        came, when the leave returned)."""
        import time

        self.col.init_collective_group(world, rank, group_name=group)
        reduced = self.col.allreduce(np.full((4,), rank + 1.0, np.float32), group_name=group)
        replied = time.monotonic()
        self.col.destroy_collective_group(group)
        return reduced.tolist(), replied, time.monotonic()


def _group(runtime, name, world):
    """A fresh group name. On the reference, its coordinator is started
    and called once before the members' first calls: the reference's
    worker starts an async actor's event loop without a lock, so calls
    that reach a fresh coordinator together can land on two loops and
    hang the round (the port's worker holds a lock; see the last test)."""
    if runtime == "ray_tpu":
        col = _collective(runtime).collective
        coordinator = ray_tpu.remote(col._GroupCoordinator).options(
            name=f"__collective_{name}", get_if_exists=True).remote(world)
        ray_tpu.get(coordinator.cleanup.remote("start the loop"), timeout=GET_TIMEOUT_S)
    return name


def _leave(ranks, runtime, group, world):
    RUNTIMES[runtime].get([m.leave.remote(group) for m in ranks[runtime][:world]],
                          timeout=GET_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(clusters):
    """Three members on each runtime, shared by the module's groups."""
    members = {name: [rt.remote(_Rank).remote(name) for _ in range(3)]
               for name, rt in RUNTIMES.items()}
    yield members
    for name, handles in members.items():
        for h in handles:
            RUNTIMES[name].kill(h)


@pytest.mark.parametrize("runtime", sorted(RUNTIMES))
def test_collective_ops(ranks, runtime):
    group = _group(runtime, "g1", 3)
    results = RUNTIMES[runtime].get(
        [m.mirror.remote(group, r, 3, float(r + 1)) for r, m in enumerate(ranks[runtime])],
        timeout=GET_TIMEOUT_S)
    _leave(ranks, runtime, group, 3)
    # sum over ranks of arange(4) * (rank + 1) = [0, 6, 12, 18], split 2/1/1
    for rank, (reduced, gathered, b, shard) in enumerate(results):
        assert reduced == [6.0, 6.0, 6.0, 6.0]  # 1+2+3
        assert gathered == [0, 1, 2]
        assert b == 42.0
        assert shard == [[0.0, 6.0], [12.0], [18.0]][rank]


def _warm_leases(n):
    """Idle CPU workers this process can lease, as after any burst of tasks:
    the ranks' tasks then go to leased workers rather than through the
    head (the first call of a function registers it through the head)."""

    @ray_tpu_torch.remote
    def noop(i):
        return i

    assert ray_tpu_torch.get([noop.remote(i) for i in range(n)],
                             timeout=GET_TIMEOUT_S) == list(range(n))


def test_collective_ops_in_tasks_on_the_port(ranks):
    """tests/test_collective.py::test_collective_ops with its ranks as
    tasks. The submitter used to queue up to 16 tasks on one leased worker,
    so rank 2 waited behind rank 1, which waited for rank 2; a leased
    worker now takes one task at a time (the reference's runtime keeps
    the queue: pinned)."""

    def worker(rank, world, value):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, group_name="g1_tasks")
        reduced = col.allreduce(np.full((4,), value, np.float32), group_name="g1_tasks")
        gathered = col.allgather(np.array([rank], np.int32), group_name="g1_tasks")
        bcast = col.broadcast(
            np.array([42.0]) if rank == 0 else None, src_rank=0, group_name="g1_tasks"
        )
        col.barrier(group_name="g1_tasks")
        return reduced.tolist(), [int(x[0]) for x in gathered], float(bcast[0])

    _warm_leases(8)
    world = 3
    f = ray_tpu_torch.remote(worker)
    results = ray_tpu_torch.get(
        [f.remote(r, world, float(r + 1)) for r in range(world)], timeout=GET_TIMEOUT_S
    )
    for reduced, gathered, b in results:
        assert reduced == [6.0, 6.0, 6.0, 6.0]  # 1+2+3
        assert gathered == [0, 1, 2]
        assert b == 42.0


def test_reducescatter_in_tasks_on_the_port(ranks):
    """tests/test_collective.py::test_reducescatter with its ranks as
    tasks, on leased workers as above."""

    def worker(rank, world):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world, rank, group_name="rs_tasks")
        shard = col.reducescatter(np.arange(4, dtype=np.float32), group_name="rs_tasks")
        return shard.tolist()

    _warm_leases(8)
    f = ray_tpu_torch.remote(worker)
    out = ray_tpu_torch.get([f.remote(r, 2) for r in range(2)], timeout=GET_TIMEOUT_S)
    # sum = [0,2,4,6]; rank0 gets [0,2], rank1 [4,6]
    assert out == [[0.0, 2.0], [4.0, 6.0]]


def test_a_leased_worker_takes_one_task_at_a_time_on_the_port_only(clusters):
    """The departure behind the two tests above, pinned: the reference's
    submitter queues up to 16 tasks on a leased worker, the port's one, and
    the rest of a burst waits at the submitter (the two tests below). So
    a burst of tasks that each wait until all have started ends on the
    port."""
    from ray_tpu._private import client as reference_client
    from ray_tpu_torch._private import client as port_client

    assert reference_client._LEASE_PIPELINE_MAX == 16
    assert port_client._LEASE_PIPELINE_MAX == 1

    @ray_tpu_torch.remote
    class Gate:
        def __init__(self, n):
            self.n, self.arrived = n, 0

        def arrive(self):
            self.arrived += 1

        def all_here(self):
            return self.arrived >= self.n

    def member(gate):
        import time

        import ray_tpu_torch as rt

        rt.get(gate.arrive.remote())
        while not rt.get(gate.all_here.remote()):
            time.sleep(0.01)
        return True

    _warm_leases(8)
    gate = Gate.remote(3)
    f = ray_tpu_torch.remote(member)
    try:
        assert ray_tpu_torch.get([f.remote(gate) for _ in range(3)],
                                 timeout=GET_TIMEOUT_S) == [True] * 3
    finally:
        ray_tpu_torch.kill(gate)


def _drop_warm_leases(client):
    """Give back every lease this process holds, as a cold start."""
    with client._lease_lock:
        leases = [lease for pool in client._leases.values() for lease in pool]
        client._leases.clear()
        client._lease_grow_hold_until.clear()
        for lease in leases:
            lease["returned"] = True
    for lease in leases:
        lease["conn"].close()
        client._send_lease_return(lease["worker_id"], lease.get("raylet", False))


def test_a_burst_past_the_pool_waits_at_the_owner_for_leases_on_the_port(
    clusters, monkeypatch
):
    """More tasks than workers: the rest wait in the submitter's backlog and
    go to leases as they drain, none through the head."""
    from ray_tpu_torch._private.worker import global_client

    client = global_client()

    @ray_tpu_torch.remote
    def double(i):
        return 2 * i

    _warm_leases(8)
    queued, via_head = [], []
    queue, submit = client._queue_leased, client.submit
    monkeypatch.setattr(client, "_queue_leased", lambda *a: queued.append(1) or queue(*a))
    monkeypatch.setattr(client, "submit", lambda spec: via_head.append(1) or submit(spec))
    n = 300
    assert ray_tpu_torch.get([double.remote(i) for i in range(n)],
                             timeout=GET_TIMEOUT_S) == [2 * i for i in range(n)]
    assert queued and not via_head
    assert not any(client._lease_backlog.values())


def test_stalled_leases_hand_their_backlog_to_the_head_on_the_port(clusters, monkeypatch):
    """A pool that cannot grow, whose one lease runs a task that waits for
    the tasks queued behind it: once the lease has stalled, the backlog goes
    through the head, which runs it on other workers."""
    from ray_tpu_torch._private.worker import global_client

    client = global_client()
    acquire = client._acquire_lease

    def one_lease(key, resources):
        with client._lease_lock:
            held = len(client._leases.get(key, ()))
        return acquire(key, resources) if held == 0 else None

    handed = []
    via_head = client._submit_via_head
    monkeypatch.setattr(client, "_acquire_lease", one_lease)
    monkeypatch.setattr(client, "_submit_via_head",
                        lambda spec: handed.append(spec.name) or via_head(spec))

    @ray_tpu_torch.remote
    class Gate:
        def __init__(self, n):
            self.n, self.arrived = n, 0

        def arrive(self):
            self.arrived += 1

        def all_here(self):
            return self.arrived >= self.n

    def member(gate):
        import time

        import ray_tpu_torch as rt

        rt.get(gate.arrive.remote())
        while not rt.get(gate.all_here.remote()):
            time.sleep(0.01)
        return True

    gate = Gate.remote(3)
    ray_tpu_torch.get(gate.all_here.remote(), timeout=GET_TIMEOUT_S)
    _drop_warm_leases(client)
    f = ray_tpu_torch.remote(member)
    try:
        assert ray_tpu_torch.get([f.remote(gate) for _ in range(3)],
                                 timeout=GET_TIMEOUT_S) == [True] * 3
    finally:
        ray_tpu_torch.kill(gate)
    assert handed == ["member", "member"]


# ------------------------------------------------------- every op, every kind


def _input(rank, seed, kind):
    x = np.random.RandomState(seed + rank).randn(6, 4).astype(np.float32)
    if kind == "numpy":
        return x
    return torch.from_numpy(x).to(getattr(torch, kind))


def _run(ranks, runtime, world, kind, seed):
    group = _group(runtime, f"every_{kind}_{world}_{seed}", world)
    out = RUNTIMES[runtime].get(
        [m.every_op.remote(group, r, world, kind, seed)
         for r, m in enumerate(ranks[runtime][:world])], timeout=GET_TIMEOUT_S)
    _leave(ranks, runtime, group, world)
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_numpy_inputs_give_the_references_results(ranks, world):
    want = _run(ranks, "ray_tpu", world, "numpy", seed=world)
    got = _run(ranks, "ray_tpu_torch", world, "numpy", seed=world)
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for k in w:
            ws, gs = (w[k], g[k]) if isinstance(w[k], list) else ([w[k]], [g[k]])
            for a, b in zip(ws, gs):
                assert isinstance(b, np.ndarray) and b.dtype == a.dtype, k
                np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("kind", ["bfloat16", "float32"])
@pytest.mark.parametrize("world", [2, 3])
def test_tensor_inputs_give_tensors_of_their_dtype(ranks, world, kind):
    seed = 10 + world
    got = _run(ranks, "ray_tpu_torch", world, kind, seed)
    xs = [_input(r, seed, kind) for r in range(world)]
    stacked = torch.stack(xs)
    for rank, out in enumerate(got):
        for op in REDUCE_OPS:
            t = out[f"allreduce_{op}"]
            assert isinstance(t, torch.Tensor) and t.dtype == xs[0].dtype and t.device.type == "cpu"
            assert torch.equal(t, TORCH_REDUCE[op](stacked)), op
        assert all(torch.equal(a, b) for a, b in zip(out["allgather"], xs))
        assert all(a.dtype == xs[0].dtype for a in out["allgather"])
        assert torch.equal(out["reducescatter"],
                           torch.tensor_split(stacked.sum(0), world, dim=0)[rank])
        assert torch.equal(out["broadcast"], xs[-1]) and out["broadcast"].dtype == xs[0].dtype
        assert torch.equal(out["broadcast_none"], xs[0])
    if kind == "float32":
        # the reference's numpy reductions of the same values, to float32
        # rounding (torch and numpy may add in another order)
        want = _run(ranks, "ray_tpu", world, "numpy", seed)
        for w, g in zip(want, got):
            for op in REDUCE_OPS:
                np.testing.assert_allclose(g[f"allreduce_{op}"].numpy(), w[f"allreduce_{op}"],
                                           rtol=1e-6, atol=1e-6)


def test_unknown_backend_raises(clusters):
    col = _collective("ray_tpu_torch")
    with pytest.raises(ValueError, match="nccl"):
        col.init_collective_group(1, 0, backend="nccl", group_name="bad")


# --------------------------------------------- phase 20's layout, on a fake GPU


def test_two_half_gpu_actors_share_the_card_and_reduce(clusters):
    """The runtime grants num_gpus=0.5 to two actors at once on a node of
    one GPU, and each sees the card (CUDA_VISIBLE_DEVICES "0"); a bf16
    allreduce and reducescatter between them equal torch's on the host."""
    rt = ray_tpu_torch
    assert rt.cluster_resources().get("GPU") == 1.0

    @rt.remote(num_gpus=0.5)
    class Member:
        def __init__(self, rank):
            from ray_tpu_torch.util import collective as col

            self.rank = rank
            col.init_collective_group(2, rank, group_name="half")

        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        def reduce(self, x):
            from ray_tpu_torch.util import collective as col

            return (col.allreduce(x, group_name="half"),
                    col.reducescatter(x, group_name="half"))

    members = [Member.remote(r) for r in range(2)]
    assert rt.get([m.visible.remote() for m in members], timeout=GET_TIMEOUT_S) == ["0", "0"]
    xs = [_input(r, 30, "bfloat16") for r in range(2)]
    got = rt.get([m.reduce.remote(x) for m, x in zip(members, xs)], timeout=GET_TIMEOUT_S)
    total = torch.stack(xs).sum(0)
    for rank, (reduced, shard) in enumerate(got):
        assert reduced.dtype == torch.bfloat16 and torch.equal(reduced, total)
        assert torch.equal(shard, total.tensor_split(2)[rank])
    for m in members:
        rt.kill(m)


def test_an_async_actor_runs_every_call_on_its_one_event_loop(ranks):
    """Calls that reach a fresh async actor together, from several
    processes, all run on its one event loop. The coordinator's
    asyncio.Event is made by one call of a round and awaited by the
    others; a second loop, started by a call on another dispatch thread,
    made those waits fail ("bound to a different event loop") until the
    port's worker started its loop under a lock."""
    import time

    @ray_tpu_torch.remote
    class Loops:
        async def loop(self):
            import asyncio

            await asyncio.sleep(0.05)
            return id(asyncio.get_running_loop())

    members = ranks["ray_tpu_torch"]
    for _ in range(ROUNDS_AT_ONCE):
        actor = Loops.remote()
        at = time.time() + 0.5
        loops = ray_tpu_torch.get([m.call_at.remote(actor, at) for m in members],
                                  timeout=GET_TIMEOUT_S)
        ray_tpu_torch.kill(actor)
        assert len({x for xs in loops for x in xs}) == 1, loops


# ------------------------------------------- leaving a group (the teardown)


class _SlowReplies(_PortCoordinator):
    """The port's coordinator, holding every rank's reply but rank 0's for
    REPLY_DELAY_S after the round completes: rank 0 returns, and leaves,
    while ranks 1 and 2 still wait on their replies."""

    async def contribute(self, key, rank, payload, op):
        import asyncio

        out = await super().contribute(key, rank, payload, op)
        if rank != 0:
            await asyncio.sleep(REPLY_DELAY_S)
        return out


class _ShortLeaveTimeout(_PortCoordinator):
    """The port's coordinator, waiting 0.5 s, not LEAVE_TIMEOUT_S, for the
    other members once the first has left."""

    def __init__(self, world_size, group_name):
        super().__init__(world_size, group_name)
        self.leave_timeout_s = 0.5


class _SlowLeave(_ShortLeaveTimeout):
    """The port's coordinator with the short leave timeout, answering a
    leave only after LEAVE_DELAY_S."""

    async def leave(self, rank):
        import asyncio

        await asyncio.sleep(LEAVE_DELAY_S)
        return await super().leave(rank)


def _alive(runtime, name):
    """Whether the named coordinator still answers."""
    rt = RUNTIMES[runtime]
    try:
        actor = rt.get_actor(name)
        return rt.get(actor.cleanup.remote("ping"), timeout=10) is True
    except (ValueError, rt.exceptions.RayActorError):
        return False


def _gone_within(runtime, name, seconds):
    import time

    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not _alive(runtime, name):
            return True
        time.sleep(0.1)
    return False


def test_rank_0_leaving_first_cuts_no_other_ranks_reply(ranks):
    """A group of three whose rank 0 destroys it as soon as its own reply
    returns, while ranks 1 and 2 still wait on theirs: every rank gets its
    result and leaves, and the coordinator ends with the last of them.
    The parent's rank 0 killed the coordinator under the others' replies,
    and their allreduce raised RayActorError."""
    group = "leave_first"
    name = f"__collective_{group}"
    ray_tpu_torch.remote(_SlowReplies).options(name=name, get_if_exists=True).remote(3, group)
    members = ranks["ray_tpu_torch"]
    out = ray_tpu_torch.get(
        [m.reduce_and_leave.remote(group, r, 3) for r, m in enumerate(members)],
        timeout=GET_TIMEOUT_S)
    assert [reduced for reduced, _, _ in out] == [[6.0] * 4] * 3
    left_0 = out[0][2]
    assert all(left_0 < replied for _, replied, _ in out[1:]), out
    assert _gone_within("ray_tpu_torch", name, 10)


@pytest.mark.parametrize("runtime", sorted(RUNTIMES))
def test_the_coordinator_outlives_rank_0s_destroy_on_the_port_only(ranks, runtime):
    """The pinned divergence: the reference's rank 0 ends the coordinator
    when it destroys the group; the port's coordinator lives until the
    last member has left."""
    group = _group(runtime, "outlives", 3)
    name = f"__collective_{group}"
    members = ranks[runtime]
    rt = RUNTIMES[runtime]
    rt.get([m.join.remote(group, r, 3) for r, m in enumerate(members)], timeout=GET_TIMEOUT_S)
    rt.get(members[0].leave.remote(group), timeout=GET_TIMEOUT_S)
    after_rank_0 = _alive(runtime, name)
    rt.get([m.leave.remote(group) for m in members[1:]], timeout=GET_TIMEOUT_S)
    after_all = not _gone_within(runtime, name, 10)
    want = (False, False) if runtime == "ray_tpu" else (True, False)
    assert (after_rank_0, after_all) == want


def test_a_member_that_never_leaves_holds_the_coordinator_only_until_its_timeout(ranks):
    """Rank 0 leaves and ranks 1 and 2 do not (as if they had crashed):
    the coordinator exits once its leave timeout has passed, and a late
    destroy on the others then returns."""
    group = "never_leaves"
    name = f"__collective_{group}"
    ray_tpu_torch.remote(_ShortLeaveTimeout).options(name=name, get_if_exists=True).remote(
        3, group)
    members = ranks["ray_tpu_torch"]
    ray_tpu_torch.get([m.join.remote(group, r, 3) for r, m in enumerate(members)],
                      timeout=GET_TIMEOUT_S)
    ray_tpu_torch.get(members[0].leave.remote(group), timeout=GET_TIMEOUT_S)
    assert _gone_within("ray_tpu_torch", name, 10)
    ray_tpu_torch.get([m.leave.remote(group) for m in members[1:]], timeout=GET_TIMEOUT_S)


def test_a_leave_the_coordinator_is_slow_to_answer_returns_and_the_coordinator_still_ends(ranks):
    """A member whose leave outlasts its wait returns from the destroy
    without raising (a GetTimeoutError there would stop a learner group's
    shutdown before it killed its learners), and the coordinator, which
    then has no member left to end it, ends on its own timeout."""
    group = "slow_leave"
    name = f"__collective_{group}"
    ray_tpu_torch.remote(_SlowLeave).options(name=name, get_if_exists=True).remote(1, group)
    (member, *_) = ranks["ray_tpu_torch"]
    ray_tpu_torch.get(member.join.remote(group, 0, 1), timeout=GET_TIMEOUT_S)
    raised, seconds = ray_tpu_torch.get(member.leave_within.remote(group, 0.5),
                                        timeout=GET_TIMEOUT_S)
    assert raised is None and seconds < LEAVE_DELAY_S, (raised, seconds)
    assert _gone_within("ray_tpu_torch", name, 10)
