"""Train-step throughput and MFU of the port on one CUDA card.

The port of the repo-root `bench.py`: forward, loss, backward and AdamW,
at its shapes (batch 2, sequence 2048, bf16 parameters, `targets =
roll(ids, -1)`, ids from `np.random.RandomState(0)`). The Llama point
(llama-1b) comes first; then, as the reference's `BENCH_MOE=1` phase,
mixtral-small (8 experts, top-2) with `moe_lm_loss`, its dispatch chosen
by `resolve_moe_dispatch` unless forced, MFU over the active parameters.
Between the two, as the reference does, the long-context sweep: the same
Llama at batch 1 over `BENCH_LONGCTX_SEQS` (default 8192,16384,32768),
`max(5, steps // 2)` timed steps each, with the chunked loss; a later
point that runs out of device memory is recorded as such and ends the
sweep. `BENCH_LONGCTX=0` or `--no-longctx` skips it. Prints one JSON line.

    python -m ray_tpu_torch.bench [--model llama-1b] [--steps 10]
        [--no-longctx] [--moe-model mixtral-small] [--moe-dispatch auto]
        [--no-moe]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ._device import card_description, resolve_device
from .models.llama import (
    CONFIGS,
    LlamaConfig,
    LlamaForCausalLM,
    chunked_causal_lm_loss,
)
from .models.mixtral import CONFIGS as MIXTRAL_CONFIGS
from .models.mixtral import (
    DISPATCHES,
    PROBE_SECONDS,
    MixtralForCausalLM,
    moe_lm_loss,
    resolve_moe_dispatch,
)
from .train import LossFn, lm_loss, make_optimizer, timed_steps, train_step

# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet).
H100_BF16_PEAK_FLOPS = 989e12
LONGCTX_SEQS = "8192,16384,32768"


def flops_per_token(n_params: float, cfg, seq_len: int) -> float:
    """6N matmul flops/token + attention score flops
    (12 * L * T * hidden per token, fwd+bwd)."""
    return 6.0 * n_params + 12.0 * cfg.num_layers * seq_len * cfg.hidden_size


def bench_model(model: torch.nn.Module, batch: int, seq: int, steps: int,
                peak_flops: float = H100_BF16_PEAK_FLOPS,
                loss_fn: Optional[LossFn] = None,
                n_params: Optional[int] = None) -> Dict[str, object]:
    """One warm-up step, then `steps` timed steps on one repeated batch.
    `loss_fn(model, ids, targets)` defaults to the causal LM loss; MFU
    counts `n_params` (default `cfg.num_params()`) against `peak_flops`.
    Returns tokens/s, step time, MFU, and the loss of every step, warm-up
    first."""
    cfg = model.cfg
    if loss_fn is None:
        loss_fn = lm_loss
    if n_params is None:
        n_params = cfg.num_params()
    device = next(model.parameters()).device
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)),
                          dtype=torch.long, device=device)
    targets = torch.roll(ids, -1, dims=1)
    optimizer = make_optimizer(model)
    losses, dt = timed_steps(lambda: train_step(model, optimizer, ids, targets, loss_fn), steps)

    tok_per_s = batch * seq * steps / dt
    mfu = tok_per_s * flops_per_token(n_params, cfg, seq) / peak_flops
    return {
        "tokens_per_s": tok_per_s,
        "step_ms": dt / steps * 1e3,
        "mfu": mfu,
        "losses": losses,
    }


def longctx_sweep(cfg: LlamaConfig, steps: int, peak_flops: float,
                  device: torch.device,
                  seqs: Sequence[int]) -> Dict[str, object]:
    """The reference's long-context sweep: a fresh Llama of `cfg` at batch
    1 for each sequence length in `seqs`, `max(5, steps // 2)` timed
    steps, `chunked_causal_lm_loss` (chunk 2048). Each point carries
    `seq`, `tokens_per_s`, `step_ms`, `mfu`, `loss` (the last step's) and,
    on the card, `peak_memory_gb`. A point after the first that runs out
    of device memory is recorded as `{"seq", "oom"}` and ends the sweep;
    any other failure, and any failure of the first point, raises. The
    headline `longctx_*` fields are the first point's."""
    points: List[Dict[str, object]] = []
    for seq in seqs:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        model = None
        try:
            model = LlamaForCausalLM(cfg, device=device)
            r = bench_model(model, 1, seq, max(5, steps // 2), peak_flops,
                            loss_fn=chunked_causal_lm_loss)
        except torch.cuda.OutOfMemoryError as exc:
            if not points:
                raise
            points.append({"seq": seq, "oom": type(exc).__name__})
            # The traceback's frames hold the optimizer and the activations.
            traceback.clear_frames(exc.__traceback__)
            r = None
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if r is None:
            break
        point = {"seq": seq, "tokens_per_s": r["tokens_per_s"], "step_ms": r["step_ms"],
                 "mfu": r["mfu"], "loss": r["losses"][-1]}
        if device.type == "cuda":
            point["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        points.append(point)
    first = points[0] if points else {}
    return {"longctx": points, "longctx_seq": first.get("seq"),
            "longctx_tokens_per_s": first.get("tokens_per_s"),
            "longctx_mfu": first.get("mfu"), "longctx_loss": first.get("loss")}


def bench_moe(name: str, dispatch: str, batch: int, seq: int, steps: int,
              peak_flops: float, device: torch.device) -> Dict[str, object]:
    """The reference's MoE phase: `name` in bf16 parameters, its dispatch
    forced or ("auto") resolved by the measured probe, MFU over the active
    parameters per token. `moe_probe_ms` holds the probe's median step of
    each backend where this call ran it, else None (forced, or resolved
    by the env override or the disk cache)."""
    cfg = replace(MIXTRAL_CONFIGS[name], param_dtype=torch.bfloat16,
                  moe_dispatch=dispatch)
    probed_before = set(PROBE_SECONDS)
    cfg = replace(cfg, moe_dispatch=resolve_moe_dispatch(cfg, tokens=batch * seq,
                                                         device=device))
    probe = [{k: t * 1e3 for k, t in s.items()}
             for key, s in PROBE_SECONDS.items() if key not in probed_before]
    r = bench_model(MixtralForCausalLM(cfg, device=device), batch, seq, steps,
                    peak_flops, loss_fn=moe_lm_loss,
                    n_params=cfg.active_params_per_token())
    return {
        "moe_model": f"{name} ({cfg.num_experts} experts, top-{cfg.num_experts_per_tok})",
        "moe_dispatch": cfg.moe_dispatch,
        "moe_probe_ms": probe[0] if probe else None,
        "moe_tokens_per_s": r["tokens_per_s"],
        "moe_step_ms": r["step_ms"],
        "moe_mfu_active": r["mfu"],
        "moe_loss": r["losses"][-1],
        "moe_losses": r["losses"],
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
    ap.add_argument("--no-longctx", action="store_true",
                    help="skip the long-context sweep (as BENCH_LONGCTX=0)")
    ap.add_argument("--moe-model", default="mixtral-small", choices=sorted(MIXTRAL_CONFIGS))
    ap.add_argument("--moe-dispatch", default="auto", choices=("auto",) + DISPATCHES,
                    help="force an MoE dispatch; 'auto' runs the measured probe")
    ap.add_argument("--no-moe", action="store_true", help="skip the MoE phase")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = replace(CONFIGS[args.model], param_dtype=torch.bfloat16)
    r = bench_model(LlamaForCausalLM(cfg, device=device), args.batch, args.seq,
                    args.steps, args.peak_flops)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the Llama model and its optimizer are gone
    longctx = {}
    if not args.no_longctx and os.environ.get("BENCH_LONGCTX", "1") != "0":
        seqs = [int(s) for s in os.environ.get("BENCH_LONGCTX_SEQS", LONGCTX_SEQS).split(",")]
        longctx = longctx_sweep(cfg, args.steps, args.peak_flops, device, seqs)
    moe = {}
    if not args.no_moe:
        moe = bench_moe(args.moe_model, args.moe_dispatch, args.batch, args.seq,
                        args.steps, args.peak_flops, device)
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
        **longctx,
        **moe,
        "device": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
