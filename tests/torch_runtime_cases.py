"""What the port's mirrors of the reference's runtime files share.

`daemon_shm` is the fixture of tests that SIGKILL a node daemon or a
head: it notes what the killed process had mapped under
`/dev/shm/rtpt_*` and unlinks what is left of it after the test (only
that process's files, so a test running beside this one keeps its own).
"""
import os

import pytest


def shm_of(pid):
    """The `/dev/shm/rtpt_*` files process `pid` has mapped: a node
    daemon's or a head's pool and segments."""
    try:
        with open(f"/proc/{pid}/maps", encoding="utf-8") as f:
            return {line.split()[-1] for line in f
                    if line.rstrip().split()[-1].startswith("/dev/shm/rtpt_")}
    except OSError:
        return set()


def unlink_all(paths):
    for path in paths:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


@pytest.fixture
def daemon_shm(monkeypatch):
    """Notes the shm of every node daemon `DaemonCluster.kill_node` kills
    and unlinks what is left of it when the test ends; yields the set so
    a test can add the files of a process it kills itself."""
    from ray_tpu_torch.cluster_utils import DaemonCluster

    left = set()
    kill_node = DaemonCluster.kill_node

    def noting_kill_node(self, proc, graceful=False):
        left.update(shm_of(proc.pid))
        return kill_node(self, proc, graceful)

    monkeypatch.setattr(DaemonCluster, "kill_node", noting_kill_node)
    yield left
    unlink_all(left)
