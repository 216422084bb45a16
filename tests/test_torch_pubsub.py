"""The port's channelized pubsub (`ray_tpu_torch.util.pubsub`),
tests/test_pubsub.py case for case: user channels, key-prefix filters,
and the GCS's built-in NODE_INFO and ACTOR lifecycle events. The
subscriber chains the client's push handler, so worker log lines still
reach the driver beside it (the last case).

One module-scoped cluster; every test has a deadline after which it fails
instead of hanging, and every `get` a timeout.
"""
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import pubsub

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
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_user_channel_roundtrip(cluster):
    got = []
    sub = pubsub.subscribe("chan-a", lambda k, d: got.append((k, d)))
    pubsub.publish("chan-a", "k1", {"x": 1})
    pubsub.publish("chan-a", "k2", [1, 2, 3])
    assert _wait(lambda: len(got) == 2), got
    assert got == [("k1", {"x": 1}), ("k2", [1, 2, 3])]
    sub.unsubscribe()
    pubsub.publish("chan-a", "k3", None)
    time.sleep(0.3)
    assert len(got) == 2  # nothing after unsubscribe


def test_key_prefix_filter(cluster):
    got = []
    pubsub.subscribe("chan-b", lambda k, d: got.append(k), key_prefix="job:")
    pubsub.publish("chan-b", "job:1", None)
    pubsub.publish("chan-b", "task:9", None)
    pubsub.publish("chan-b", "job:2", None)
    assert _wait(lambda: len(got) >= 2)
    time.sleep(0.2)
    assert got == ["job:1", "job:2"]


def test_publish_from_worker_reaches_driver(cluster, capfd):
    """A worker's publish reaches the driver's subscriber, and the
    worker's printed line still reaches the driver's console through the
    chained push handler."""
    got = []
    pubsub.subscribe("events", lambda k, d: got.append((k, d)))

    @ray_tpu_torch.remote
    def announce():
        from ray_tpu_torch.util import pubsub as ps

        print("rtpt-pubsub-log-line", flush=True)
        ps.publish("events", "from-worker", {"pid": True})
        return "sent"

    assert ray_tpu_torch.get(announce.remote(), timeout=GET_TIMEOUT_S) == "sent"
    assert _wait(lambda: got and got[0][0] == "from-worker"), got
    seen = []
    assert _wait(lambda: seen.append(capfd.readouterr().out)
                 or "rtpt-pubsub-log-line" in "".join(seen)), seen


def test_actor_lifecycle_channel(cluster):
    events = []
    pubsub.subscribe("ACTOR", lambda k, d: events.append((k, d["state"])))

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    assert _wait(lambda: any(s == "ALIVE" for _, s in events)), events
    ray_tpu_torch.kill(a)
    assert _wait(lambda: any(s == "DEAD" for _, s in events)), events


def test_node_lifecycle_channel(cluster):
    from ray_tpu_torch.cluster_utils import Cluster

    events = []
    pubsub.subscribe("NODE_INFO", lambda k, d: events.append(d["state"]))
    c = Cluster(initialize_head=False)
    node = c.add_node(num_cpus=1, label="pub-test")
    # As in the reference: the virtual add_node emits no ALIVE and its
    # removal no death event; the subscription must stay live through
    # both.
    c.remove_node(node)
    pubsub.publish("NODE_INFO", "probe", {"state": "PROBE"})
    assert _wait(lambda: "PROBE" in events), events
