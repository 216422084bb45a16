"""Where a train step's device time goes, from `torch.profiler`.

    python -m ray_tpu_torch.profile [--model mixtral-small]
        [--moe-dispatch gmm] [--remat-policy dots] [--batch 2]
        [--seq 2048] [--chunked-loss]

Builds the model as `bench` does (Llama and Mixtral in bf16 parameters,
GPT in its config's float32 parameters; batch 2, sequence 2048, AdamW;
`--chunked-loss` takes the long-context sweep's loss, for Llama),
runs one warm-up step, times 3 steps, then profiles 3 more on the
card. The profiler slows the host, so it prints the wall time
per step with and without it, the device's busy share of the profiled wall
time (the union of kernel intervals), the kernel time per step over the
unprofiled step, the kernels by device time per step with their calls
per step, and the host's operators by their own CPU time per step.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ._device import card_description, resolve_device
from .models.gpt import CONFIGS as GPT_CONFIGS
from .models.gpt import GPTForCausalLM
from .models.llama import CONFIGS, LlamaForCausalLM, chunked_causal_lm_loss
from .models.mixtral import CONFIGS as MIXTRAL_CONFIGS
from .models.mixtral import DISPATCHES, MixtralForCausalLM, moe_lm_loss
from .train import lm_loss, make_optimizer, train_step

STEPS, TOP = 3, 30


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, -float("inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="mixtral-small",
                    choices=sorted(CONFIGS) + sorted(MIXTRAL_CONFIGS) + sorted(GPT_CONFIGS))
    ap.add_argument("--moe-dispatch", default="gmm", choices=DISPATCHES)
    ap.add_argument("--remat-policy", default=None, choices=("dots", "nothing"),
                    help="override the config's remat policy")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--chunked-loss", action="store_true",
                    help="Llama only: chunked_causal_lm_loss, as the long-context sweep")
    args = ap.parse_args(argv)
    if args.chunked_loss and args.model not in CONFIGS:
        ap.error("--chunked-loss applies to the Llama models only")

    device = resolve_device(None)  # the card: a CPU profile measures nothing of it
    if args.model in MIXTRAL_CONFIGS:
        cfg = replace(MIXTRAL_CONFIGS[args.model], param_dtype=torch.bfloat16,
                      moe_dispatch=args.moe_dispatch)
        model_cls, loss_fn = MixtralForCausalLM, moe_lm_loss
    elif args.model in GPT_CONFIGS:
        cfg, model_cls, loss_fn = GPT_CONFIGS[args.model], GPTForCausalLM, lm_loss
    else:
        cfg = replace(CONFIGS[args.model], param_dtype=torch.bfloat16)
        model_cls = LlamaForCausalLM
        loss_fn = chunked_causal_lm_loss if args.chunked_loss else lm_loss
    if args.remat_policy:
        if args.model in GPT_CONFIGS:
            ap.error("GPT has no remat policy (remat recomputes the whole block)")
        cfg = replace(cfg, remat_policy=args.remat_policy)
    model = model_cls(cfg, device=device)
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (args.batch, args.seq)),
                          dtype=torch.long, device=device)
    targets = torch.roll(ids, -1, dims=1)
    optimizer = make_optimizer(model)
    float(train_step(model, optimizer, ids, targets, loss_fn))  # warm-up

    def run_steps() -> float:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            train_step(model, optimizer, ids, targets, loss_fn)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e6

    plain_us = run_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = run_steps()

    per_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        # Annotations such as "Optimizer.step#AdamW.step" span kernels that
        # are counted on their own.
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        per_kernel[evt.name][0] += end - start
        per_kernel[evt.name][1] += 1
    device_us = sum(us for us, _ in per_kernel.values())
    print(f"{args.model} b{args.batch} s{args.seq} on {card_description()}: "
          f"{plain_us / STEPS / 1e3:.3f} ms/step, {wall_us / STEPS / 1e3:.3f} ms/step "
          f"profiled, device busy {busy_us(intervals) / wall_us:.4f} of the profiled "
          f"steps, kernel time {device_us / STEPS / 1e3:.3f} ms/step = "
          f"{device_us / plain_us:.4f} of the unprofiled step")
    print(f"remat {getattr(cfg, 'remat_policy', 'nothing')}; ms/step  share  calls/step  kernel")
    for name, (us, calls) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{us / STEPS / 1e3:7.3f}  {us / device_us:5.3f}  {calls / STEPS:10.1f}  {name[:110]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"host operators' own CPU time {host_us / STEPS / 1e3:.3f} ms/step; "
          "ms/step  calls/step  operator")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:TOP]:
        print(f"{e.self_cpu_time_total / STEPS / 1e3:12.3f}  {e.count / STEPS:10.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
