"""Train-step throughput and MFU of the Llama port on one CUDA card.

The port of `bench_model` in the repo-root `bench.py`: the Llama forward,
loss, backward and AdamW update, at its shapes (llama-1b, batch 2,
sequence 2048, bf16 parameters, `targets = roll(ids, -1)`, ids from
`np.random.RandomState(0)`). Prints one JSON line.

    python -m ray_tpu_torch.bench [--model llama-1b] [--steps 10]
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import Dict, List

import numpy as np
import torch

from ._device import card_description, resolve_device
from .models.llama import (
    CONFIGS,
    LlamaForCausalLM,
    causal_lm_loss,
    chunked_causal_lm_loss,
)

# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet).
H100_BF16_PEAK_FLOPS = 989e12


def flops_per_token(n_params: float, cfg, seq_len: int) -> float:
    """6N matmul flops/token + attention score flops
    (12 * L * T * hidden per token, fwd+bwd)."""
    return 6.0 * n_params + 12.0 * cfg.num_layers * seq_len * cfg.hidden_size


def make_optimizer(model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW as the reference's `optax.adamw(3e-4, b1=0.9, b2=0.95)`:
    optax decays every leaf by 1e-4 (torch's default is 1e-2). With bf16
    parameters both moments are bf16, as `mu_dtype=bfloat16` gives."""
    return torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.95),
                             eps=1e-8, weight_decay=1e-4)


def train_step(model, optimizer, ids, targets, *, chunked_loss=False):
    """One forward, loss, backward and update; returns the loss (on the
    device, not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    if chunked_loss:
        loss = chunked_causal_lm_loss(model, ids, targets)
    else:
        loss = causal_lm_loss(model(ids), targets)
    loss.backward()
    optimizer.step()
    return loss.detach()


def bench_model(model: LlamaForCausalLM, batch: int, seq: int, steps: int,
                peak_flops: float = H100_BF16_PEAK_FLOPS,
                chunked_loss: bool = False) -> Dict[str, object]:
    """One warm-up step, then `steps` timed steps on one repeated batch.
    Returns tokens/s, step time, MFU against `peak_flops`, and the loss of
    every step, warm-up first."""
    cfg = model.cfg
    device = next(model.parameters()).device
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                          dtype=torch.long, device=device)
    targets = torch.roll(ids, -1, dims=1)
    optimizer = make_optimizer(model)

    losses: List[torch.Tensor] = [
        train_step(model, optimizer, ids, targets, chunked_loss=chunked_loss)
    ]
    float(losses[0])  # waits for the warm-up step
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(
            train_step(model, optimizer, ids, targets, chunked_loss=chunked_loss)
        )
    float(losses[-1])  # waits for the last step
    dt = time.perf_counter() - t0

    tok_per_s = batch * seq * steps / dt
    mfu = tok_per_s * flops_per_token(cfg.num_params(), cfg, seq) / peak_flops
    return {
        "tokens_per_s": tok_per_s,
        "step_ms": dt / steps * 1e3,
        "mfu": mfu,
        "losses": [float(x) for x in losses],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-1b", choices=sorted(CONFIGS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--peak-flops", type=float, default=H100_BF16_PEAK_FLOPS)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = replace(CONFIGS[args.model], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device)
    r = bench_model(model, args.batch, args.seq, args.steps, args.peak_flops)
    card = card_description() if device.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"{args.model} train step tokens/s (b{args.batch} "
                  f"s{args.seq}, loss {r['losses'][-1]:.3f}, MFU {r['mfu']:.3f})",
        "value": r["tokens_per_s"],
        "unit": "tokens/s",
        "step_ms": r["step_ms"],
        "mfu": r["mfu"],
        "peak_flops": args.peak_flops,
        "losses": r["losses"],
        "device": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
