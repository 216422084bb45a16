"""The port's microbenchmarks (`python -m ray_tpu_torch._private.ray_perf`).

Two benchmarks run on a small cluster within a minute: the placement-group
group through `main`, which writes its JSON only where `--out` says, and
one task benchmark. Then the soaks' knobs: every environment name
ray_perf sets is one the port reads (`RAY_TPU_TORCH_<key>` of its config,
or a name its chaos module reads itself), so no soak runs without the
faults it claims to inject. Every test has a deadline.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import ray_perf
from ray_tpu_torch._private.config import _DEFAULTS

DEADLINE_S = 60
PORT = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _perf_json_stat():
    path = os.path.join(os.getcwd(), "PERF.json")
    return os.stat(path).st_mtime_ns if os.path.exists(path) else None


def test_pgs_and_a_task_benchmark_on_a_small_cluster(tmp_path):
    ray_perf.RESULTS.clear()
    out = tmp_path / "perf.json"
    before = _perf_json_stat()
    t0 = time.perf_counter()
    assert ray_perf.main(["--only", "pgs", "--num-cpus", "2", "--out", str(out)]) == 0
    # Only where --out says: no PERF.json written in the working directory.
    assert os.listdir(tmp_path) == ["perf.json"] and _perf_json_stat() == before
    report = json.loads(out.read_text())
    rate = report["results"]["placement_group_create/removal"]
    assert rate > 0
    assert report["per_benchmark"]["placement_group_create/removal"] == {
        "raw": rate, "ratio_vs_baseline": round(rate / ray_perf.BASELINE[
            "placement_group_create/removal"], 3)}
    assert "upstream Ray 2.31.0" in report["baseline_source"]
    ray_tpu_torch.init(num_cpus=2)
    try:
        sync = ray_perf.timeit(
            "single_client_tasks_sync",
            lambda: ray_tpu_torch.get(ray_perf.tiny_task.remote(), timeout=30),
            min_time=1.0)
    finally:
        ray_tpu_torch.shutdown()
    assert sync > 0 and ray_perf.RESULTS["single_client_tasks_sync"] == round(sync, 2)
    assert time.perf_counter() - t0 < DEADLINE_S


def _names_read_outside_config():
    """RAY_TPU_TORCH_* names the port's modules read themselves."""
    names = set()
    for dirpath, _, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py") and fn != "ray_perf.py":
                with open(os.path.join(dirpath, fn)) as f:
                    names |= set(re.findall(
                        r'environ(?:\.get\(|\[)\s*"RAY_TPU_TORCH_(\w+)"', f.read()))
    return names


def test_every_knob_the_soaks_set_is_one_the_port_reads():
    with open(ray_perf.__file__) as f:
        source = f.read()
    # No knob of the reference's (RAY_TPU_<key>) is left in the copy.
    assert not re.findall(r'"RAY_TPU_(?!TORCH_)\w+"', source)
    knobs = set(re.findall(r'"RAY_TPU_TORCH_(\w+)"', source))
    assert {"chaos_spec", "chaos_seed", "chaos_epoch", "health_score_alpha",
            "health_suspect_score", "health_quarantine_score", "health_readmit_score",
            "hedge_overrun_factor", "object_store_memory_bytes",
            "pull_in_flight_bytes"} <= knobs
    own = _names_read_outside_config()
    unread = sorted(k for k in knobs if k not in _DEFAULTS and k not in own)
    assert not unread, f"ray_perf sets knobs the port never reads: {unread}"
    # Each config knob takes effect: the value a soak sets is the one a
    # fresh process's config reads.
    env, want = dict(os.environ), {}
    for key in sorted(knobs & set(_DEFAULTS)):
        default = _DEFAULTS[key]
        want[key] = ("1:kill:test" if isinstance(default, str)
                     else (not default) if isinstance(default, bool) else default + 1)
        env[f"RAY_TPU_TORCH_{key}"] = str(want[key])
    code = ("import json; from ray_tpu_torch._private.config import RayConfig; "
            f"print(json.dumps({{k: getattr(RayConfig, k) for k in {sorted(want)!r}}}))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=DEADLINE_S, check=True, cwd=os.path.dirname(PORT))
    assert json.loads(out.stdout) == want
