"""Phase 28 of chip_smoke.py rehearsed on the CPU at llama-tiny: the
runtime under a seeded chaos schedule with the lock witness armed in every
process, an actor restart after its worker is SIGKILLed (28a), a task
retry after a chaos rule kills its first attempt (28b) and no lock-order
inversion in any process (28c), through the phase's own code with a spec
whose device is the CPU. The runtime reports one (fake) GPU, so the actor
and the task ask for it as on the card, and the killed worker's GPU must
be given back before the restart or the retry can take it. The checks
that need the card (its name, the kernels' launches) are listed by the
phase instead of made, and the test holds that list, so a broken phase
shows here before a chip run.
"""
import signal

import pytest
import torch

DEADLINE_S = 150
# The checks of 28a-28b that need the card, as the phase names them.
CARD_CHECKS = ["28a card", "28a card", "28a launches", "28b card", "28b launches"]


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_phase_28_runs_at_llama_tiny_on_the_cpu(capsys, monkeypatch):
    from dataclasses import replace

    import chip_smoke as S
    from ray_tpu_torch._private import chaos, lock_witness
    from ray_tpu_torch.bench import bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "1")
    spec = S.surface_spec(model="llama-tiny", device="cpu", requests=4, min_len=16,
                          max_len=128, batch=2, seq=64, num_cpus=4)
    # Phase 5's losses, at the rehearsal's size: a warm-up and one step.
    cfg = replace(CONFIGS["llama-tiny"], param_dtype=torch.bfloat16)
    in_process = bench_model(LlamaForCausalLM(cfg, device="cpu"), 2, 64, 1)
    was_witnessed = lock_witness.installed()
    out = S.phase_faults("the CPU (rehearsal)", in_process, spec)
    assert out["skipped"] == CARD_CHECKS
    assert out["readings"]["retry_losses"] == in_process["losses"][:S.FAULT_STEPS]
    assert out["readings"]["restart_s"] is not None
    # The phase leaves no schedule and no witness behind it.
    assert chaos.active() is None
    assert lock_witness.installed() == was_witnessed
    printed = capsys.readouterr().out
    for line in ("28a:", "28b:", "28c:"):
        assert line in printed and ": ok" in printed.split(line, 1)[1].splitlines()[0], printed
    # The actor and the retried task held the runtime's one GPU.
    for line in ("28a:", "28b:"):
        assert "CUDA_VISIBLE_DEVICES=0" in printed.split(line, 1)[1].splitlines()[0], printed
