"""The port's runtime_env plugins (`ray_tpu_torch._private.runtime_env_plugins`):
the three plugin cases of tests/test_runtime_env.py, case for case, and
what is the port's own: the pip plugin's venv cache lies under the port's
temp root, never the reference's, and a task keeps its runtime_env on
every call, however it reaches its worker.

The wheel is the reference test's own hand-rolled one, installed offline.
One module-scoped cluster under a temp root of the module's own; every
test has a deadline after which it fails instead of hanging, and every
`get` a timeout.
"""
import os
import signal
import tempfile

import pytest

import ray_tpu_torch
from test_runtime_env import _make_wheel

DEADLINE_S = 120
GET_TIMEOUT_S = 100


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
def root(tmp_path_factory):
    """The port's temp root for this module; the cluster's workers
    inherit it."""
    path = str(tmp_path_factory.mktemp("rtpt_root"))
    old = os.environ.get("RAY_TPU_TORCH_TEMP_DIR")
    os.environ["RAY_TPU_TORCH_TEMP_DIR"] = path
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield path
    ray_tpu_torch.shutdown()
    if old is None:
        os.environ.pop("RAY_TPU_TORCH_TEMP_DIR", None)
    else:
        os.environ["RAY_TPU_TORCH_TEMP_DIR"] = old


# ----------------------------------- tests/test_runtime_env.py, plugins


def test_pip_plugin_venv_isolation(root, tmp_path):
    """A pip runtime_env installs into a cached venv whose packages are
    importable ONLY inside tasks carrying that env."""
    wheel = _make_wheel(tmp_path)

    @ray_tpu_torch.remote
    def with_pkg():
        import tinypkg

        return tinypkg.VALUE

    @ray_tpu_torch.remote
    def without_pkg():
        try:
            import tinypkg  # noqa: F401

            return "leaked"
        except ImportError:
            return "isolated"

    env = {"pip": [wheel]}
    assert ray_tpu_torch.get(with_pkg.options(runtime_env=env).remote(),
                             timeout=GET_TIMEOUT_S) == 42
    assert ray_tpu_torch.get(without_pkg.remote(), timeout=GET_TIMEOUT_S) == "isolated"


def test_pip_plugin_bad_requirement_fails_loudly(root):
    @ray_tpu_torch.remote
    def f():
        return 1

    with pytest.raises(ray_tpu_torch.exceptions.RayTaskError) as ei:
        ray_tpu_torch.get(
            f.options(runtime_env={"pip": ["/nonexistent/nowhere-9.9.whl"]}).remote(),
            timeout=GET_TIMEOUT_S,
        )
    assert "pip" in str(ei.value)


def test_container_plugin_gated(root):
    @ray_tpu_torch.remote
    def f():
        return 1

    # No docker/podman on this host: rejected at validation time.
    with pytest.raises(ValueError):
        f.options(runtime_env={"container": {"image": "x"}}).remote()


# ------------------------------------------------------- the port's own


def test_pip_venv_cache_lies_under_the_ports_temp_root(root, tmp_path):
    wheel = _make_wheel(tmp_path, name="rootpkg", body="VALUE = 7\n")

    @ray_tpu_torch.remote
    def where():
        import rootpkg

        return rootpkg.VALUE, rootpkg.__file__

    value, path = ray_tpu_torch.get(
        where.options(runtime_env={"pip": [wheel]}).remote(), timeout=GET_TIMEOUT_S)
    assert value == 7
    cache = os.path.join(root, "runtime_env", "pip")
    assert path.startswith(cache + os.sep), path
    # Nothing under the reference's cache for this requirement set.
    digest = os.path.relpath(path, cache).split(os.sep)[0]
    assert not os.path.exists(os.path.join(
        tempfile.gettempdir(), "ray_tpu", "runtime_env", "pip", digest))


def test_every_call_keeps_its_runtime_env(root, tmp_path):
    """The leased route's compact frame carries no runtime_env, so a task
    with one never takes it: the env holds on the first call and on
    every later one, and a bad pip env fails every call."""
    @ray_tpu_torch.remote
    def flag():
        return os.environ.get("RTPT_PLUGIN_FLAG")

    env = {"env_vars": {"RTPT_PLUGIN_FLAG": "on"}}
    got = [ray_tpu_torch.get(flag.options(runtime_env=env).remote(), timeout=GET_TIMEOUT_S)
           for _ in range(4)]
    assert got == ["on"] * 4
    assert ray_tpu_torch.get(flag.remote(), timeout=GET_TIMEOUT_S) is None

    @ray_tpu_torch.remote
    def one():
        return 1

    assert ray_tpu_torch.get(one.remote(), timeout=GET_TIMEOUT_S) == 1  # registered, leasable
    bad = {"pip": [str(tmp_path / "missing-1.0-py3-none-any.whl")]}
    for _ in range(2):
        with pytest.raises(ray_tpu_torch.exceptions.RayTaskError, match="pip"):
            ray_tpu_torch.get(one.options(runtime_env=bad).remote(), timeout=GET_TIMEOUT_S)
