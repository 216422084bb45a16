"""Phase 27 of chip_smoke.py rehearsed on the CPU: Mixtral's other meshes
(27a) at mixtral-tiny in float32 over 4 gloo ranks (in bf16 on the CPU,
whose matmuls round by their thread count, a loss can sit near the
phase's 1e-3 limit), the C
client calling a llama-tiny actor (27b) and the native store and codec
(27c), through the phase's own code with a spec whose device is the CPU.
The launches that 27a holds on the card are counted here through the
kernels' plain versions against the same `mesh_launches`, so a broken
phase or a wrong count shows before a chip run. `--phase 30c-bf16`'s
measurement of the tensor split (the loss gap and the tokens the split
moves between experts) runs through its own code here too, in float32.
"""
import signal

import numpy as np
import pytest

DEADLINE_S = 240


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _spec(S):
    return S.mesh_spec(model="mixtral-tiny", device="cpu", batch=2, seq=64,
                       param_dtype="float32", dtype="float32")


def test_phase_27a_runs_at_mixtral_tiny_on_the_cpu(capsys):
    import chip_smoke as S

    out = S.phase_meshes("the CPU (rehearsal)", _spec(S))
    assert list(out) == [label for label, _, _, _ in S.MESH_CASES]
    printed = capsys.readouterr().out
    for label, _, _, _ in S.MESH_CASES:
        line = next(x for x in printed.splitlines() if x.startswith(f"27a mixtral-tiny on ")
                    and f"({dict((c[0], c[2]) for c in S.MESH_CASES)[label]}," in x
                    and " x ".join(f"{a} {n}" for a, n in
                                   dict((c[0], c[1]) for c in S.MESH_CASES)[label].items()) in x)
        assert line.endswith("host-staged exchange)") and ": ok;" in line, line


def test_phase_27a_launch_counts(capsys):
    """The launches `mesh_launches` expects of each mesh, counted over the
    ranks through the plain versions of K1-K5 (`run_counted`)."""
    from dataclasses import replace

    import chip_smoke as S
    import torch
    from ray_tpu_torch.models.mixtral import CONFIGS
    from ray_tpu_torch.parallel.launch import run_mixtral_trains, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from torch_staged_ranks import run_counted

    spec = _spec(S)
    cfg = replace(CONFIGS["mixtral-tiny"], param_dtype=torch.float32, dtype=torch.float32)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (spec["batch"], spec["seq"]))
    cases = [(MeshSpec(**axes), replace(cfg, moe_dispatch=d)) for _, axes, d, _ in S.MESH_CASES]
    res = spawn(run_counted, 4, run_mixtral_trains, cases, ids, 1, "cpu", deadline_s=180)
    for i, (label, axes, dispatch, _) in enumerate(S.MESH_CASES):
        got = {name: sum(r[i]["launches"].get(name, 0) + r[i]["gmm_launches"].get(name, 0)
                         for r in res)
               for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "gmm", "tgmm")}
        assert got == S.mesh_launches(axes, cfg.num_layers, dispatch, 2), label
        if dispatch == "gmm":
            assert all(r[i]["gmm_launches"]["gmm"] > 0 for r in res)


def test_phase_27b_and_27c_run_at_llama_tiny_on_the_cpu(capsys):
    import chip_smoke as S

    out = S.phase_c_client("the CPU (rehearsal)",
                           S.surface_spec(model="llama-tiny", device="cpu"))
    assert out["skipped"] == ["27b", "27b"]
    printed = capsys.readouterr().out
    for tag in ("27b: the C client", "27c: the native object store"):
        line = next(x for x in printed.splitlines() if x.startswith(tag))
        assert line.endswith(": ok"), line


def test_phase_30c_bf16_measures_a_split_at_mixtral_tiny_on_the_cpu(capsys):
    """`chip_smoke.py --phase 30c-bf16`'s measurement through its own code,
    over 4 gloo ranks at mixtral-tiny in float32: there the split moves no
    token between experts, and every loss is within 1e-5 of one
    process's (the limit test_torch_expert.py holds this mesh to)."""
    from ray_tpu_torch.models.mixtral import CONFIGS
    import chip_smoke as S

    steps = 3
    out = S.phase_bf16_split("the CPU (rehearsal)", 4, None, {**_spec(S), "steps": steps},
                             backend="gloo")
    layers = CONFIGS["mixtral-tiny"].num_layers
    assert len(out["losses"]) == len(out["one_card_losses"]) == steps
    assert [len(row) for row in out["tokens_moved"]] == [layers] * steps
    assert all(n == 0 for row in out["tokens_moved"] for n in row), out["tokens_moved"]
    assert max(out["relative_gaps"]) <= 1e-5, out["relative_gaps"]
    printed = capsys.readouterr().out
    assert sum(x.startswith("30c-bf16 step ") for x in printed.splitlines()) == steps
