"""Phase 26 of chip_smoke.py rehearsed on the CPU at llama-tiny: the
compiled DAG serving the model three ways (26a), the workflow that trains,
fails in its last step and resumes (26b), and the thin client with no card
(26c), through the phase's own code with a spec whose device is the CPU.
The checks that need the card (its name, the kernels' launches) are
listed by the phase instead of made, and the test holds that list, so a
broken phase shows here before a chip run.
"""
import signal

import pytest
import torch

DEADLINE_S = 150
# The checks of 26a-26c that need the card, as the phase names them.
CARD_CHECKS = ["26a card", "26a launches", "26a launches .remote()", "26b card",
               "26b launches", "26c card", "26c launches", "26c card", "26c launches"]


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_phase_26_runs_at_llama_tiny_on_the_cpu(capsys):
    from dataclasses import replace

    import chip_smoke as S
    from ray_tpu_torch.bench import bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    spec = S.surface_spec(model="llama-tiny", device="cpu", requests=4, min_len=16,
                          max_len=128, batch=2, seq=64, steps=2, num_cpus=4)
    # Phase 5's losses, at the rehearsal's size.
    cfg = replace(CONFIGS["llama-tiny"], param_dtype=torch.bfloat16)
    in_process = bench_model(LlamaForCausalLM(cfg, device="cpu"), 2, 64, 1)
    out = S.phase_surface("the CPU (rehearsal)", in_process, spec, parts="abc")
    assert out["skipped"] == CARD_CHECKS
    printed = capsys.readouterr().out
    for line in ("compiled DAG llama-tiny", "workflow on", "thin client on"):
        assert line in printed and ": ok" in printed.split(line, 1)[1].splitlines()[0], printed
