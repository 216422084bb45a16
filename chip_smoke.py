#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: the card's name and power limit;
2. build: every kernel source in `ray_tpu_torch/ops/csrc/`, in parallel;
   every kernel's registers and spills from ptxas, with the shared memory
   per block of the bf16 Hopper kernels (`fwd_sm90`, `dkv_sm90`,
   `dq_sm90`, `gmm_sm90` in both forms, `tgmm_sm90`), none of which may
   spill;
3. attention kernels: K1 (forward), K2 (dK, dV) and K3 (dQ) against their
   plain PyTorch versions, which run in float32 on the same bf16-rounded
   inputs, at the Llama path's shape (D 128), the Mixtral path's (D 64,
   and its GQA of 16 heads over 8) and at ragged, non-causal, float32,
   GQA and bf16 edge cases (D 72 and 96 on zero-filled columns, ragged
   Tq < Tk, Tq 777 under the causal mask, one tile), element-wise and by
   normwise relative error per tile; K1, K2 and K3 give bitwise-equal
   outputs over two launches; times at both paths' shapes of each kernel,
   its plain version and a library call as a yardstick the port never
   calls: `scaled_dot_product_attention` for K1, PyTorch's
   flash-attention backward for the K2 + K3 pair;
4. grouped-matmul kernels: K4 (gmm, and its dlhs form on transposed
   expert matrices) and K5 (tgmm) against their plain versions at the
   Mixtral path's shapes, from a real top-2 layout of 4096 tokens over 8
   experts, and at an empty expert (K5 writes zeros), one expert owning
   every tile, K and N off the kernel's tile, mixtral-tiny's widths, a
   layout of block_m 256, float32, and (K4 alone) tile ids past the last
   expert, which both K4 and its plain version clamp; K4, its dlhs form
   and K5 give bitwise-equal outputs over two launches; times of each,
   its plain version and `torch._grouped_mm` as the yardstick;
5. Llama train: `ray_tpu_torch.bench` at llama-1b, batch 2, sequence
   2048, bf16 parameters, one warm-up and three timed steps; the loss is
   finite and falls, and every kernel was launched as often as the model
   needs;
6. chunked loss: `chunked_causal_lm_loss` (chunk 1024) equals
   `causal_lm_loss` on the same parameters;
7. MoE dispatch: one mixtral-small layer in float32, the "gmm" dispatch
   (K4, K5) against the "ragged" oracle (`torch.matmul` per expert):
   logits and every gradient;
8. Mixtral train: mixtral-small at full width and depth (8 layers, 8
   experts, top-2), batch 2, sequence 2048, bf16 parameters, "gmm"
   dispatch, one warm-up and three timed steps with `moe_lm_loss`; the
   loss is finite and falls, and K1-K5 were launched as often as the
   model needs;
9. dispatch probe: `resolve_moe_dispatch` times "capacity" against "gmm"
   (its disk cache in a temporary directory); the pick is printed, not
   checked;
10. attention kernels at this slice's shapes: K1-K3 against their plain
   versions, as in phase 3, at the long-context sweep's (16 heads of 128,
   T 8192, 16384 and 32768, held on 16, 4 and 2 heads where the plain
   versions' float32 score matrices must fit, timed on all 16) and at
   GPT's (gpt2-large b4 s1024: 80 heads of 64); times as in phase 3;
11. GPT: a 2-layer model at gpt2-large's widths on the card against the
   same weights on the CPU's plain path (bf16 logits and loss); then
   gpt2-large at full width and depth (36 layers, float32 parameters,
   bf16 compute, remat), batch 4, sequence 1024, one warm-up and three
   timed steps; the loss is finite and falls, and K1-K3 were launched as
   often as the model needs;
12. long context: `ray_tpu_torch.bench.longctx_sweep` as the bench runs
   it (llama-1b, bf16 parameters, batch 1, T 8192, 16384 and 32768, 5
   timed steps each, chunked loss), with each point's peak memory; a
   later point may be recorded as out of memory; losses finite, and
   K1-K3 launched as often as the points need;
13. ring blocks in one process: K1 without the causal mask at the ring's
   per-rank shape (16 heads of 128, T 8192), held and timed as in phase
   10; then two blocks of one query shard (the diagonal, causal, and an
   earlier one) merged as ring attention merges them, the merged o and
   lse held against the plain attention over both blocks' keys, and K2
   and K3 given that GLOBAL (o, lse) on each block held against their
   plain versions on the same inputs;
14. the ring over 4 ranks sharing the card (`parallel.launch.spawn`,
   gloo, neighbour exchange through pinned host memory): each rank's
   backend and card are printed; ring attention at llama-1b's attention
   shape (b1, 16 heads of 128, T 32768 global) against single-card
   `flash_attention` on the gathered tensors, o and every gradient; then
   the sequence-parallel llama-1b train step (seq 4, b1, T 32768, bf16
   parameters, chunked loss, one step then three timed): every loss
   equals the same step's loss on one card from the same weights and
   ids, every rank ends with the same parameters, the losses are finite
   and fall, and K1-K3 were launched as often as the ring needs, summed
   over the ranks (future blocks run no kernel). FSDP and
   tensor parallelism do not run on one card, and the phase says so;
15. the pipeline over 2 ranks sharing the card (`parallel.pipeline`,
   gloo, activations and their gradients through pinned host memory):
   llama-1b's 22 decoder layers at full width as 2 stages of 11, 4
   microbatches of b1 s2048, bf16 parameters, x the seed-0 embedding of
   `RandomState(0)` ids; one pipelined forward and backward of mean(y^2)
   against `sequential_reference` on the card with the same layers (y and
   every stage's gradients, normwise per 64-row tile), then three timed
   SGD steps: every loss finite and equal to the same steps on one card,
   the loss falling, and K1-K3 launched on each rank as often as its stage's microbatches
   need (bubble ticks run no stage); the step of the slowest rank, the
   peak memory per rank and the bubble share (S - 1) / (M + S - 1);
16. expert parallelism over 4 ranks sharing the card (data 2 x expert 2,
   4 experts a rank): mixtral-small at full width and depth, b2 s2048
   (one row a data replica), bf16 parameters, remat "dots", "capacity"
   forced by the mesh, `moe_lm_loss` with AdamW; one step and three
   timed: every loss equal to the same steps on one card with
   "capacity", the ranks of a data pair holding equal parameters and the
   parameters that are not experts equal on all four, losses finite and
   falling, K1-K3 launched as often as the model needs, summed over the
   ranks; each rank's backend and card, the slowest rank's step and the
   peak memory per rank. The dense four-axis dryrun
   (`ray_tpu_torch.dryrun`) does not run on one card, and the phase says
   so.
17. the runtime (`ray_tpu_torch.init()` with no arguments): the card
   detected as GPU 1; a 64 MiB bf16 CUDA tensor put by this process and
   taken by a `num_gpus=1` actor, which sees CUDA_VISIBLE_DEVICES 0 and
   the card, moves it there and checksums its bits there; a CUDA tensor
   the actor puts, got here bitwise equal to the actor's host copy; a
   task without `num_gpus` sees CUDA_VISIBLE_DEVICES "" and no device;
   the times and GB/s of each put and get;
18. `TorchTrainer` at llama-1b, one GPU worker: the loop runs phase 5
   (the same model, seed and batches through `bench_model`) with K1-K3
   counted in the worker, reports each loss and saves the state dict
   with `save_pytree` into its checkpoint; the losses equal phase 5's
   (rtol 1e-3) and fall, the launches are phase 5's per step, and the
   checkpoint reloaded into a fresh llama-1b on this card gives the
   worker's loss of a fixed batch (rtol 1e-5); the worker's step beside
   phase 5's;
19. Data into TorchTrainer at llama-1b, one GPU worker: `ray_tpu_torch.data`
   `from_numpy` of TIMED_STEPS + 1 blocks, each phase 5's batch, and a
   `map_batches` adding `targets = roll(ids, -1)` in numpy, passed as
   `datasets={"train": ds}`; the worker steps phase 5's model on
   `iter_torch_batches(batch_size=BATCH, dtypes=torch.long)` (pinned host
   memory, a non_blocking copy to the card): every batch on the card,
   K1-K3 launched 2L/L/L per step in the worker, the losses within
   TRAINER_LOSS_RTOL of phase 5's and falling; the Data-fed step beside
   phase 5's and phase 18's, the host's wait for each next batch, the
   host-to-device copy of one batch (ms, GB/s) and fit();
20. collectives (`ray_tpu_torch.util.collective`): two actors of
   `num_gpus=0.5`, both on the card, each with a 16 MiB CUDA tensor of
   bf16 and then of float32: allreduce, allgather, reducescatter and
   broadcast equal torch's reduction of the same inputs on the host, and
   come back on the caller's card in its dtype; the ms of each op;
21. Tune (`ray_tpu_torch.tune`): a `Tuner` over a `TorchTrainer` of one
   GPU worker, a grid of two learning rates (`make_optimizer`'s, phase
   5's, and TUNE_OTHER_LR), two trials at once that queue on the card
   through their placement groups; each trial's worker runs phase 5's
   llama-1b (the same model, seed and batch) for a warm-up and
   TUNE_STEPS timed steps with K1-K3 counted in the worker: no trial
   errs, every trial launches 2L/L/L per step, the trial at phase 5's
   rate gives phase 5's losses of the same steps (TRAINER_LOSS_RTOL),
   the other finite losses that differ after the first step; each
   trial's losses, launches, step, its worker's wall seconds, and the
   wait between the first trial's worker ending and the second's
   starting;
22. RLlib PPO (`ray_tpu_torch.rllib`) with one learner of one GPU
   (`num_learners=1, num_gpus_per_learner=1`) at tests/test_rllib.py's
   settings: the learner on `cuda`; one update of the card learner and of
   a CPU learner from the same start weights on the same batch (built by
   the CPU learner), every metric and updated weight within
   PPO_CARD_ATOL; the update's ms per minibatch on each. Then the
   default: a local learner with `num_gpus_per_learner` unset is on the
   card and holds the same limit, and a learner actor would take one
   card; the same update with TF32 matmuls is printed as the control. Where gymnasium
   is installed, the batch is sampled from CartPole-v1 by the CPU env
   runner, and then up to 20 iterations run with the reference test's
   settings: each iteration's sample ms and `episode_return_mean`, every
   loss finite, and the best return at least the reference's 80. Where
   it is not installed, the batch is built without an env from
   CartPole's shapes, and the phase says so;
23. Serve (`ray_tpu_torch.serve`): `serve.start(proxy=False)` and a
   `LlamaServer` deployment of one GPU holding llama-1b (seed 0, bf16
   parameters); its `@serve.batch(max_batch_size=8,
   batch_wait_timeout_s=0.2)` method right-pads a batch and runs the
   forward under `inference_mode`. Two rounds of 16 requests of 128-2048
   tokens, each round sent at once through the handle: the replica on
   the card, every response's last-position logits within GPT's bf16
   limit of the same request alone through this process's llama-1b and
   the same next token wherever the top two logits differ by more than
   the row's largest difference, at least one batch of more than one
   request, K1 launched 22 times per batch in the replica and K2, K3
   never; the seconds from `serve.run` to ready, the batch sizes, each
   round's latency p50 and p99, the replica's forward ms per batch (the
   first apart) beside the same shapes in this process, prefill tokens/s;
24. the rest of RLlib, every learner local with `num_gpus_per_learner`
   unset (the card), built without gymnasium on CartPole's and
   Pendulum's shapes from RandomState seeds: DQN (prioritized replay,
   QNetworkModule at its defaults), IMPALA and APPO (the PPO module's
   widths), SAC and CQL (256, 256), MARWIL and BC, each against a CPU
   learner holding its start state, one update on the same batch (and,
   for SAC and CQL, the same draws, made once on the CPU): every metric
   and weight within RL_CARD_ATOL; the DQN target synced and the SAC and
   CQL polyak step on the card; the ms of the first update and three
   warm ones on each, and for the replay algorithms the host's
   sample-and-copy ms per update (the card's warm updates then take the
   copied batches, as DQN's and SAC's training steps do). A few hundred CartPole-shaped episodes
   through `SampleWriter` and `OfflineData` on the port's Data, each
   exactly, feed MARWIL and BC. Two PPO policies through
   `MultiAgentLearnerGroup` (local learners on the card): each policy's
   weights equal a single-agent learner's on its episodes. DreamerV3 at
   its `DreamerV3Config` defaults (deter 256, 8 x 8 stochastic, units
   256, B 8, T 32, horizon 15): one train step on the card against the
   CPU's with the same Gumbel draws, within DREAMER_CARD_RTOL (which a
   TF32 control must exceed), each weight group (world model, actor,
   critic, slow critic) within DREAMER_STEP_SHARE of its own one Adam
   step (the TF32 control must exceed these too), and its ms per train
   step on each. Where gymnasium is installed, the tuned
   examples run with their learners on the card: `pendulum_sac.yaml`
   must clear its bar, and `cartpole_dqn.yaml`'s best is printed (the
   reference's own run of it stays below its bar); where it is not, the
   phase says so;
25. a job on an autoscaled GPU node: `python -m ray_tpu_torch start
   --head --num-cpus 2 --num-gpus 0 --port 0` (a head with no GPU, under
   a temp root of the phase's own), `init(address="auto")` here and a v2
   `Reconciler` over `GpuHostProvider(MockGpuHostApi(), ...)` whose one
   group type is one host of 4 CPUs and this card (idle timeout
   JOB_IDLE_TIMEOUT_S); `python -m ray_tpu_torch submit --wait
   --runtime-env-json ... -- python3 chip_smoke.py --job-driver`, whose
   driver (`init(address="auto")`, no torch) runs one `num_gpus=1` task
   that takes phase 5's llama-1b steps with K1-K3 counted in its worker.
   Checks: the job SUCCEEDED; the task ran on the node the reconciler
   launched (label `v2:<instance>:h0`), not the head, with
   CUDA_VISIBLE_DEVICES "0" and this card; K1-K3 launched 2L/L/L per
   step; the losses within TRAINER_LOSS_RTOL of phase 5's; while the job
   ran, `list_nodes()`, `python -m ray_tpu_torch list nodes` and (where
   aiohttp is installed) the dashboard's /api/nodes and /api/jobs show
   the node alive with GPU 1 and the job; `summary tasks` counts the
   task finished; the group scaled down within JOB_IDLE_TIMEOUT_S +
   JOB_SCALE_DOWN_SLACK_S of the job's end and the node reads dead;
   after `python -m ray_tpu_torch stop` the head has exited and no port
   process or `rtpt_` pool that the phase started is left. Prints the
   seconds from submit to the node's registration, to the task's first
   step and to the job's end, the task's step beside phase 5's, the
   seconds from the job's end to scale-down, and whether the dashboard
   ran.

The line before last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

# Tolerances of a bf16 kernel against its float32 plain version: o is
# rounded to bf16 (2^-8 relative), gradients also sum over thousands of
# terms in another order.
O_TOL = 2e-2
LSE_ATOL = 1e-3
GRAD_TOL = 3e-2
# Causal gradients shrink along the sequence (|dV_j| ~ 1/sqrt(j)), so an
# element-wise atol near their size cannot see a wrong late tile. Each
# output (o, dq, dk, dv) is also held to a normwise relative error,
# ||kernel - plain|| / ||plain||, over the whole tensor and over every
# tile of TILE rows of the sequence on its own. bf16 output rounding
# alone gives about 1e-3.
REL_TOL = 1e-2
TILE = 64
# float32 kernels against float32 plain versions: the kernels' products
# carry about 16 bits of mantissa (each float operand as bf16 hi + lo),
# and sums run in another order. Used for every check of a float32 case.
F32_TOL = 2e-4
CHUNKED_LOSS_RTOL = 1e-3
# K4 and K5 (bf16) against their float32 plain versions: each output is
# rounded to bf16 (2^-9 relative), and sums run in another order. The
# element-wise atol is GMM_TOL times the output's root mean square, since
# outputs grow with the rows summed (K5) or the width (K4). The normwise
# errors are taken over the whole output and over every GMM_TILE rows of it
# (K4, one layout tile) or every expert (K5).
GMM_TOL = 2e-2
GMM_TILE = 128

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

MAIN = dict(bh=32, tq=2048, tk=2048, d=128, causal=True)  # llama-1b b2 s2048
MIXTRAL_ATTN = dict(bh=32, tq=2048, tk=2048, d=64, causal=True)  # mixtral-small b2 s2048
BATCH, SEQ, TIMED_STEPS = 2, 2048, 3
# The long-context sweep's attention (llama-1b b1: 16 heads of 128):
# (heads, T, heads held against the plain versions, None for all).
LONG_ATTN = ((16, 8192, None), (16, 16384, 4), (16, 32768, 2))
# gpt2-large b4 s1024: 4 x 20 heads of 64.
GPT_BATCH, GPT_SEQ = 4, 1024
GPT_ATTN = dict(bh=GPT_BATCH * 20, tq=GPT_SEQ, tk=GPT_SEQ, d=64, causal=True)
# bf16 GPT logits on the card against the CPU's plain path: each side
# rounds activations to bf16 at other points (about 1% normwise at
# gpt2-tiny against the flax model, tests/test_torch_gpt.py).
GPT_LOGITS_REL = 2e-2
# The bench's default --steps: the sweep times max(5, steps // 2) steps.
LONGCTX_BENCH_STEPS = 10
# Ring attention: 4 ranks share the card; llama-1b at batch 1, T 32768,
# split into 4 shards of 8192 (16 heads of 128 each).
RING_RANKS, RING_SEQ, RING_HEADS, RING_D = 4, 32768, 16, 128
RING_TIMED_STEPS, RING_CHUNK = 3, 2048
# Each sequence-parallel loss against the same step on one card: bf16
# activations round at other points (the ring merges per-block o in
# float32 and rounds once; the single kernel rounds its own o), and the
# bf16 gradients are summed over the ranks in another order, which moves
# only AdamW updates whose gradient is near zero (a first step is about
# lr * sign(g)).
RING_LOSS_RTOL = 1e-3
# The pipeline: llama-1b's 22 layers as 2 stages of 11 on 2 ranks sharing
# the card, 4 microbatches of b1 s2048, SGD on mean(y^2) (the reference
# dryrun's loss and step). The dryrun's rate of 0.1 makes this loss rise
# on llama-1b's layers; at 1e-3 it falls.
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO, PIPE_LR = 2, 11, 4, 1e-3
# Expert parallelism: mixtral-small on data 2 x expert 2, 4 ranks sharing
# the card.
EXPERT_DATA, EXPERT_EP = 2, 2
# The runtime's object plane: a 64 MiB bf16 tensor each way between the
# driver and a one-GPU actor.
OBJECT_MIB = 64
# TorchTrainer's worker against phase 5 in this process: the same
# kernels, card, seed and batches, so the losses should be bitwise equal.
TRAINER_LOSS_RTOL = 1e-3
# The checkpoint reloaded on the driver's card against the worker's own
# no-grad loss of the same batch.
RELOAD_LOSS_RTOL = 1e-5
# Phase 19 times the host-to-device copy of one batch over this many copies.
H2D_REPEATS = 20
# Phase 20: each rank's tensor for every collective op.
COLLECTIVE_MIB = 16
# Phase 21: each trial's timed steps after its warm-up (phase 5 times
# TIMED_STEPS), and the grid's second learning rate (the first is
# make_optimizer's, phase 5's).
TUNE_STEPS, TUNE_OTHER_LR = 2, 1e-3
# Phase 22: the card learner against the CPU learner after one update of
# 8 epochs of 15 minibatches (120 Adam steps): float32 on both, sums in
# another order on each device (about 1e-7 in the weights and 1e-6 in the
# metrics on the H100). The same update with TF32 matmuls is printed
# beside it as the control this limit must tell apart.
# tests/test_rllib.py's PPO settings, threshold and budget.
PPO_CARD_ATOL = 1e-5
PPO_THRESHOLD, PPO_ITERATIONS = 80.0, 20
# Phase 24: each learner on the card against a CPU learner after one
# update from the same state on the same batch and draws, float32 on
# both, as phase 22's PPO (metrics relative past 1; on an H100 1.2e-7
# at most, weights 2.1e-6). DreamerV3's train step chains 32 recurrent
# steps and a 15-step rollout: its metrics read 1.2e-7 on the card and
# 2.8e-4 with TF32 matmuls, the control its limit must stay under. Its
# weights take one Adam step, which moves each weight by about its
# group's lr (lr times the gradient's sign): each group is held within
# DREAMER_STEP_SHARE of its own step (world model lr 1e-4, actor and
# critic 3e-5), and the slow critic, which moves (1 - critic_ema_decay)
# of the critic's step, within that share of its own; a learner that
# skipped a group's step, or took half of it, fails. On an H100 the
# groups read 4.1e-6, 6.8e-8, 7.8e-8 and 7.5e-9, and with TF32 matmuls
# 6.6-6.7 times their limits, which the control must exceed. A few hundred CartPole-shaped episodes
# cross SampleWriter and the port's Data.
RL_CARD_ATOL = PPO_CARD_ATOL
RL_WARM_UPDATES = 3
RL_OFFLINE_STEPS = 30_000
DREAMER_CARD_RTOL = 1e-5
DREAMER_STEP_SHARE = 0.3
# Phase 23: Serve. Two rounds of SERVE_REQUESTS requests, sent at once
# through the handle to one num_gpus=1 llama-1b replica, whose
# `@serve.batch` method takes up to SERVE_MAX_BATCH of them within
# SERVE_WAIT_S; request lengths from RandomState(0) in [SERVE_MIN_LEN,
# SERVE_MAX_LEN], ids from RandomState(1). Each response's last-position
# logits against the same request alone through this process's llama-1b.
# Both sides run the same bf16 weights through the same kernels; a
# request's rows meet the same K1 tiles batched or alone, and only the
# GEMMs' row counts differ (the worst normwise error read 2.70e-07 on an
# H100). So the limit sits far below what a wrong or mixed row would give.
SERVE_MODEL = "llama-1b"
SERVE_REQUESTS, SERVE_ROUNDS = 16, 2
SERVE_MAX_BATCH, SERVE_WAIT_S = 8, 0.2
SERVE_MIN_LEN, SERVE_MAX_LEN = 128, 2048
SERVE_LOGITS_REL = 1e-4
SERVE_TIMEOUT_S = 300
# Phase 23 times this process's forward of each batch shape over this many runs.
SERVE_FORWARD_REPEATS = 3
# Phase 25: a job on an autoscaled GPU node. The reconciler's idle
# timeout, and the time after the job's end within which the node's
# group must be gone (the drain of an idle node ends at the daemon's next
# heartbeat). The job's task builds llama-1b and takes phase 5's steps.
JOB_IDLE_TIMEOUT_S = 5.0
JOB_SCALE_DOWN_SLACK_S = 30.0
JOB_TIMEOUT_S = 300
JOB_RESULT_TAG = "JOB_RESULT "
# mixtral-small b2 s2048: 4096 tokens routed top-2 over 8 experts, hidden
# 1024, expert MLP 3584.
MOE_TOKENS, MOE_EXPERTS, MOE_TOPK, MOE_D, MOE_F = BATCH * SEQ, 8, 2, 1024, 3584
SOURCES = {
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:75"),
    "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:201"),
    "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:262"),
    "gmm": ("ray_tpu_torch/ops/csrc/gmm.cu", "ray_tpu/ops/gmm.py:36"),
    "tgmm": ("ray_tpu_torch/ops/csrc/gmm.cu", "ray_tpu/ops/gmm.py:64"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_errs(got, want, tile=TILE):
    """Normwise relative error of `got` [..., T, D] against `want`: over
    the whole tensor, and the largest over tiles of `tile` rows of T."""
    import torch.nn.functional as F

    t = got.shape[-2]
    d2 = (got - want).pow(2).sum(-1).reshape(-1, t).sum(0)
    r2 = want.pow(2).sum(-1).reshape(-1, t).sum(0)
    pad = -t % tile
    d2t = F.pad(d2, (0, pad)).view(-1, tile).sum(1)
    r2t = F.pad(r2, (0, pad)).view(-1, tile).sum(1)
    whole = float((d2.sum() / r2.sum().clamp_min(1e-30)).sqrt())
    worst = float((d2t / r2t.clamp_min(1e-30)).sqrt().max())
    return whole, worst


def assert_close(name, got, want, atol, rtol, rel=None, tile=TILE):
    """Element-wise allclose and, where `rel` is given, both errors of
    `rel_errs` (tiles of `tile` rows) at most `rel`. Returns [max |got -
    want|, normwise relative error, worst tile's], the last two 0 where
    `rel` is None."""
    import torch

    err = max_err(got, want)
    got, want = got.detach().float(), want.detach().float()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, atol=atol, rtol=rtol)
    check(ok, f"{name}: max |kernel - plain| = {err:.3e} "
              f"(atol {atol}, rtol {rtol})")
    if rel is None:
        return [err, 0.0, 0.0]
    # The worst tile's error bounds the whole tensor's from above.
    whole, worst_tile = rel_errs(got, want, tile)
    check(worst_tile <= rel, f"{name}: normwise relative error {whole:.3e}, "
                             f"worst {tile}-row tile {worst_tile:.3e} (limit {rel})")
    return [err, whole, worst_tile]


def worst(*errs):
    """Element-wise max of `assert_close` results."""
    return [max(col) for col in zip(*errs)]


def fmt(e) -> str:
    return f"max|err| {e[0]:.3e}, rel {e[1]:.2e}, tile rel {e[2]:.2e}"


# Cycles the card spins before a timed run (a few ms), long enough for the
# host to queue every timed launch behind it.
SPIN_CYCLES = 10_000_000


def time_ms(fn, iters: int = 10) -> float:
    """Device time per call of `fn`: CUDA events around `iters` calls,
    queued while the card spins, so that the host's time between launches
    (the wrappers' Python and ctypes work) is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(q, k) pairs the causal (end-aligned) mask lets through."""
    if not causal:
        return tq * tk
    return tq * (tk - tq + 1) + tq * (tq - 1) // 2


def bound(bytes_moved: float, flops: float, flops_rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def ptxas_kernels(report: str):
    """[(kernel, registers, spill bytes)] from an `nvcc -Xptxas -v`
    report; a kernel of namespace `flash` or `grouped` is named as in its
    source, with an integer or bool template argument (`dkv_sm90<128>`,
    `gmm_sm90<true>`)."""
    import re

    found, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            m = re.match(r"_ZN(?:5flash|7grouped)(\d+)(\w+)", name)
            if m:
                n, rest = int(m.group(1)), m.group(2)
                t = re.match(r"IL([ib])(\d+)E", rest[n:])
                if t and t.group(1) == "b":
                    name = rest[:n] + ("<true>" if t.group(2) == "1" else "<false>")
                else:
                    name = rest[:n] + (f"<{t.group(2)}>" if t else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append((name, int(m.group(1)), spill))
    return found


# The bf16 Hopper kernels of each source: (library, C function giving the
# dynamic shared memory per block, its arguments).
SM90_KERNELS = {
    "fwd_sm90<64>": ("flash_fwd", "flash_fwd_sm90_smem_bytes", (64,)),
    "fwd_sm90<128>": ("flash_fwd", "flash_fwd_sm90_smem_bytes", (128,)),
    "dkv_sm90<64>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (64, 0)),
    "dkv_sm90<128>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (128, 0)),
    "dq_sm90<64>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (64, 1)),
    "dq_sm90<128>": ("flash_bwd", "flash_bwd_sm90_smem_bytes", (128, 1)),
    "gmm_sm90<false>": ("gmm", "gmm_sm90_smem_bytes", ()),
    "gmm_sm90<true>": ("gmm", "gmm_sm90_smem_bytes", ()),
    "tgmm_sm90": ("gmm", "tgmm_sm90_smem_bytes", (MOE_EXPERTS,)),
}


def report_build(build) -> None:
    """Prints every kernel's registers and spills, and the shared memory
    per block of the bf16 Hopper kernels; fails if one of those is
    missing from the reports or spills."""
    import ctypes

    def smem(lib, fn_name, args):
        fn = getattr(build.library(lib), fn_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
        return fn(*args)

    seen = set()
    for lib in ("flash_fwd", "flash_bwd", "gmm"):
        parts = []
        for name, regs, spill in ptxas_kernels(build.ptxas_report(lib)):
            text = f"{name} {regs} registers, {spill} spill bytes"
            if name in SM90_KERNELS:
                check(spill == 0, f"ptxas: {name} spills {spill} bytes")
                text += f", {smem(*SM90_KERNELS[name])} bytes of shared memory"
                seen.add(name)
            parts.append(text)
        print(f"ptxas {lib}.cu: " + "; ".join(parts), flush=True)
    check(seen == set(SM90_KERNELS), f"ptxas reports lack {set(SM90_KERNELS) - seen}")


def library_flash_bwd(q, k, v, do, causal: bool, scale: float):
    """A call of PyTorch's own flash-attention backward on [B, H, T, D]
    inputs, with o and lse from its own forward; returns (dq, dk, dv)."""
    import torch

    aten = torch.ops.aten
    o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False, scale=scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed, offset,
        scale=scale)


def attention_cases(A, seed):
    """(case, rand): `case` holds K1-K3 against their plain versions at
    one shape and, where `timed`, returns each kernel's numbers there;
    `rand` draws bf16 (or `dtype`) normal tensors on the card from
    `seed`."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(bh, tq, tk, d, causal, dtype=torch.bfloat16, timed=False, check_bh=None):
        """With `check_bh`, the kernels run on all `bh` heads and are held
        against the plain versions on the first `check_bh` of them, where
        the plain versions are also timed: at long T the float32 score
        matrices of every head would not fit on the card."""
        cb = check_bh or bh
        tag = f"bh{bh} tq{tq} tk{tk} d{d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
        if cb < bh:
            tag += f", held on {cb} heads"
        q, k, v, do = rand(bh, tq, d, dtype=dtype), rand(bh, tk, d, dtype=dtype), \
            rand(bh, tk, d, dtype=dtype), rand(bh, tq, d, dtype=dtype)
        qf, kf, vf, dof = (x[:cb].float() for x in (q, k, v, do))
        kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
        f32 = dtype == torch.float32
        o_tol = F32_TOL if f32 else O_TOL
        g_tol = F32_TOL if f32 else GRAD_TOL
        lse_tol = F32_TOL if f32 else LSE_ATOL
        rel = F32_TOL if f32 else REL_TOL

        o, lse = A._flash_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = A._flash_fwd_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        e_fwd = worst(assert_close(f"K1 o [{tag}]", o[:cb], o_p, o_tol, o_tol, rel),
                      assert_close(f"K1 lse [{tag}]", lse[:cb], lse_p, lse_tol, 0.0))
        # The backward kernels take the plain forward's lse and delta (on
        # the heads not held, K1's), so each is held against its plain
        # version on identical inputs.
        delta_p = (dof * o_p).sum(-1)
        lse_in, delta = lse_p, delta_p
        if cb < bh:
            lse_in = torch.cat([lse_p, lse[cb:]])
            delta = torch.cat([delta_p, (do[cb:].float() * o[cb:].float()).sum(-1)])
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dk_p, dv_p = A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta_p, **kw)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        dq_p = A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta_p, **kw)
        torch.cuda.synchronize()
        e_dkv = worst(assert_close(f"K2 dk [{tag}]", dk[:cb], dk_p, g_tol, g_tol, rel),
                      assert_close(f"K2 dv [{tag}]", dv[:cb], dv_p, g_tol, g_tol, rel))
        e_dq = assert_close(f"K3 dq [{tag}]", dq[:cb], dq_p, g_tol, g_tol, rel)
        print(f"kernels [{tag}]: K1 {fmt(e_fwd)}; K2 {fmt(e_dkv)}; "
              f"K3 {fmt(e_dq)}; limit rel {rel}: ok", flush=True)
        if not timed:
            return None
        # One writer per output: a second launch gives the same bits.
        o2, lse2 = A._flash_fwd_cuda(q, k, v, **kw)
        dk2, dv2 = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dq2 = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        same = all(torch.equal(x, y) for x, y in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2),
                                                    (dq, dq2)))
        check(same, f"K1/K2/K3 [{tag}]: two launches on the same inputs differ")
        print(f"deterministic [{tag}]: o, lse, dk, dv and dq bitwise equal over two launches",
              flush=True)

        el = q.element_size()
        pairs = bh * visible_pairs(tq, tk, causal)
        qb, kb = bh * tq * d * el, bh * tk * d * el
        rows = bh * tq * 4  # one float32 per q row (lse, delta)
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        res = {}
        res["flash_fwd"] = dict(
            max_abs_err=e_fwd[0],
            ms=time_ms(lambda: A._flash_fwd_cuda(q, k, v, **kw)),
            plain_ms=time_ms(lambda: A._flash_fwd_plain(qf, kf, vf, **kw)),
            bound=bound(2 * qb + 2 * kb + rows, 4 * d * pairs, rate),
        )
        b, h = 2, bh // 2
        q4, k4, v4, do4 = (t.view(b, h, -1, d) for t in (q, k, v, do))
        res["flash_fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        # The library's flash backward gives dq, dk and dv in one call from
        # its own forward's o and lse: one yardstick for the K2 + K3 pair,
        # held to the plain version first (on the held heads) so that it
        # computes the same.
        lib_bwd = library_flash_bwd(q4, k4, v4, do4, causal, kw["sm_scale"])
        lib_held = lib_bwd if cb == bh else library_flash_bwd(
            *(t[:cb].view(1, cb, -1, d) for t in (q, k, v, do)), causal, kw["sm_scale"])
        for name, got, want in zip(("dq", "dk", "dv"), lib_held(), (dq_p, dk_p, dv_p)):
            assert_close(f"library {name} [{tag}]", got.reshape(cb, -1, d), want,
                         g_tol, g_tol, rel)
        del lib_held
        pair_lib_ms = time_ms(lib_bwd)
        res["flash_bwd_dkv"] = dict(
            max_abs_err=e_dkv[0],
            ms=time_ms(lambda: A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_p, delta_p,
                                                            **kw)),
            bound=bound(2 * qb + 4 * kb + 2 * rows, 8 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        res["flash_bwd_dq"] = dict(
            max_abs_err=e_dq[0],
            ms=time_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)),
            plain_ms=time_ms(lambda: A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_p, delta_p,
                                                           **kw)),
            bound=bound(3 * qb + 2 * kb + 2 * rows, 6 * d * pairs, rate),
            library_ms=pair_lib_ms,
        )
        held = "" if cb == bh else f" on {cb} of {bh} heads"
        for name, r in res.items():
            lib = "" if name == "flash_fwd" else " for dq, dk and dv together"
            print(f"time {name} [{tag}]: kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms{held}, bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]}), library {r['library_ms']:.3f} ms{lib}",
                  flush=True)
        pair = res["flash_bwd_dkv"]["ms"] + res["flash_bwd_dq"]["ms"]
        print(f"time K2 + K3 [{tag}]: {pair:.3f} ms, library {pair_lib_ms:.3f} ms "
              f"(dq, dk and dv in one call)", flush=True)
        return res

    return case, rand


def phase_kernels(A):
    """Holds K1-K3 against their plain versions; returns each kernel's
    numbers at the main path's shape."""
    import torch

    case, rand = attention_cases(A, seed=0)
    main = case(**MAIN, timed=True)
    # The Mixtral path's shape (mixtral-small b2 s2048: 16 heads of 64),
    # timed too: its times stand beside the Llama shape's in PERF.md.
    case(**MIXTRAL_ATTN, timed=True)
    case(8, 1000, 1500, 128, True)           # ragged tails, Tq < Tk
    case(8, 777, 1024, 64, False)            # non-causal, ragged q
    case(4, 900, 600, 128, False)            # non-causal, Tq > Tk
    case(4, 300, 300, 72, True, dtype=torch.float32)  # float32, D % 16 != 0
    case(2, 256, 256, 128, True, dtype=torch.float32)  # float32 at the most shared memory
    case(2, 64, 64, 8, True)                 # one tile, smallest D
    # bf16 edges of the Hopper K1-K3: the 128-wide instance on
    # zero-filled columns, ragged Tq < Tk under the causal mask (Tq 777:
    # lse rows stored one by one), one block.
    case(4, 1000, 1100, 72, True)
    case(4, 1000, 1100, 96, True)
    case(4, 777, 1000, 128, True)
    case(4, 777, 1000, 64, True)
    case(1, 64, 64, 128, True)

    def gqa(b, h, hkv, t, d):
        """GQA through the public entry point, forward and backward, with
        o and every gradient held element-wise and per TILE rows."""
        q, k, v = rand(b, h, t, d), rand(b, hkv, t, d), rand(b, hkv, t, d)
        do = rand(b, h, t, d)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = A.flash_attention(*leaves, causal=True)
        o.backward(do)
        ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
        o_r = A.attention_reference(*ref_leaves, causal=True)
        o_r.backward(do.float())
        torch.cuda.synchronize()
        tag = f"GQA b{b} h{h} hkv{hkv} t{t} d{d}"
        errs = [assert_close(f"{tag} o", o, o_r, O_TOL, O_TOL, REL_TOL)]
        for name, x, xr in zip(("dq", "dk", "dv"), leaves, ref_leaves):
            errs.append(assert_close(f"{tag} {name}", x.grad, xr.grad, GRAD_TOL, GRAD_TOL,
                                     REL_TOL))
        print(f"kernels [{tag} through flash_attention]: {fmt(worst(*errs))}; "
              f"limit rel {REL_TOL}: ok", flush=True)

    gqa(2, 16, 4, 1024, 128)
    gqa(2, 16, 8, SEQ, 64)  # the Mixtral path's attention: 16 heads over 8 KV heads
    return main


def library_grouped_mm(lhs, rhs, dout, tile_group, num_groups, block_m=128):
    """A yardstick the port never calls: `torch._grouped_mm` over each
    expert's row range of the layout (offsets from tile_group), as calls
    for K4, its dlhs form and K5; None where this install's PyTorch does
    not take these inputs (then there is no one library call to time)."""
    import torch

    groups = torch.arange(num_groups, dtype=torch.int32, device=lhs.device)
    offs = (torch.searchsorted(tile_group, groups, right=True) * block_m).to(torch.int32)
    calls = {
        "gmm": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
        "gmm_dlhs": lambda: torch._grouped_mm(dout, rhs.transpose(1, 2), offs=offs),
        "tgmm": lambda: torch._grouped_mm(lhs.t(), dout, offs=offs),
    }
    try:
        for call in calls.values():
            call()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError) as exc:  # the yardstick only
        print(f"library: torch._grouped_mm does not take these inputs ({exc}); "
              "library_ms is null", flush=True)
        return None
    return calls


def phase_gmm(G):
    """Holds K4 and K5 against their plain versions; returns each kernel's
    numbers at the Mixtral path's gate/up shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def routed(tokens, experts, skip=(), block_m=128):
        """(dst, tile_group, m) of a top-2 layout of random router logits,
        with the experts in `skip` never chosen."""
        logits = torch.randn(tokens, experts, generator=gen, device="cuda")
        logits[:, list(skip)] = -math.inf
        e_flat = logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1)
        _, dst, tile_group, m = G.aligned_group_layout(e_flat, experts, block_m)
        return dst, tile_group, m

    def case(tag, dst, tile_group, m, e, k, n, dtype=torch.bfloat16, timed=False, empty=(),
             block_m=128, k5=True):
        """K4 (lhs [m, k] @ rhs [e, k, n]), its dlhs form (dout [m, n] @
        rhs^T) and, unless not `k5`, K5 (lhs^T dout per expert). Rows
        outside `dst` are the layout's zero rows, as the model fills them
        (all rows where dst is None)."""
        def rows(width, scale=1.0):
            if dst is None:
                return rand(m, width, dtype=dtype, scale=scale)
            x = torch.zeros((m, width), dtype=dtype, device="cuda")
            x[dst] = rand(dst.numel(), width, dtype=dtype, scale=scale)
            return x

        lhs, dout = rows(k), rows(n)
        rhs = rand(e, k, n, dtype=dtype, scale=k ** -0.5)
        lf, rf, df = lhs.float(), rhs.float(), dout.float()
        f32 = dtype == torch.float32
        tol = F32_TOL if f32 else GMM_TOL
        rel = F32_TOL if f32 else REL_TOL
        kw = dict(block_m=block_m)

        def close(name, got, want, per_expert=False):
            atol = tol * float(want.pow(2).mean().sqrt())
            if per_expert:  # [E, K, N] as E rows, one tile each
                return assert_close(name, got.view(1, e, -1), want.view(1, e, -1), atol, tol,
                                    rel, tile=1)
            return assert_close(name, got, want, atol, tol, rel, tile=GMM_TILE)

        out = G._gmm_cuda(lhs, rhs, tile_group, **kw)
        dlhs = G._gmm_cuda(dout, rhs, tile_group, transpose_rhs=True, **kw)
        torch.cuda.synchronize()
        want = G._gmm_plain(lf, rf, tile_group, **kw)
        want_t = G._gmm_plain(df, rf, tile_group, transpose_rhs=True, **kw)
        e_gmm = worst(close(f"K4 [{tag}]", out, want),
                      close(f"K4 dlhs [{tag}]", dlhs, want_t))
        if not k5:
            print(f"gmm kernels [{tag}]: K4 {fmt(e_gmm)}; limit rel {rel}: ok", flush=True)
            return None
        drhs = G._tgmm_cuda(lhs, dout, tile_group, e, **kw)
        want_d = G._tgmm_plain(lf, df, tile_group, e, **kw)
        e_tgmm = close(f"K5 [{tag}]", drhs, want_d, per_expert=True)
        for x in empty:
            check(bool((drhs[x] == 0).all()), f"K5 [{tag}]: expert {x} has no tiles, "
                                              f"but its drhs is not all zeros")
        print(f"gmm kernels [{tag}]: K4 {fmt(e_gmm)}; K5 {fmt(e_tgmm)}; "
              f"limit rel {rel}{'; empty experts ' + str(list(empty)) + ' zero' if empty else ''}"
              f": ok", flush=True)
        if not timed:
            return None
        # One writer per output tile: a second launch gives the same bits.
        again = {"K4": (out, G._gmm_cuda(lhs, rhs, tile_group, **kw)),
                 "K4 dlhs": (dlhs, G._gmm_cuda(dout, rhs, tile_group, transpose_rhs=True, **kw)),
                 "K5": (drhs, G._tgmm_cuda(lhs, dout, tile_group, e, **kw))}
        for name, (first, second) in again.items():
            check(torch.equal(first, second), f"{name} [{tag}]: two launches on the same "
                                              f"inputs differ")
        print(f"deterministic [{tag}]: K4, K4 dlhs and K5 bitwise equal over two launches",
              flush=True)

        el = lhs.element_size()
        flops = 2 * m * k * n
        moved = (m * k + e * k * n + m * n) * el  # each input read once, the output written once
        rate = F32_FLOPS if f32 else BF16_FLOPS
        lib = library_grouped_mm(lhs, rhs, dout, tile_group, e)
        wants = {"gmm": want, "gmm_dlhs": want_t, "tgmm": want_d}
        lib_ms = dict.fromkeys(wants)
        for name, want_lib in wants.items() if lib else ():
            close(f"library {name} [{tag}]", lib[name](), want_lib, per_expert=name == "tgmm")
            lib_ms[name] = time_ms(lib[name])
        res = {
            "gmm": dict(max_abs_err=e_gmm[0],
                        ms=time_ms(lambda: G._gmm_cuda(lhs, rhs, tile_group, **kw)),
                        plain_ms=time_ms(lambda: G._gmm_plain(lf, rf, tile_group, **kw)),
                        bound=bound(moved, flops, rate), library_ms=lib_ms["gmm"]),
            "gmm_dlhs": dict(ms=time_ms(lambda: G._gmm_cuda(dout, rhs, tile_group,
                                                            transpose_rhs=True, **kw)),
                             plain_ms=time_ms(lambda: G._gmm_plain(df, rf, tile_group,
                                                                   transpose_rhs=True, **kw)),
                             bound=bound(moved, flops, rate), library_ms=lib_ms["gmm_dlhs"]),
            "tgmm": dict(max_abs_err=e_tgmm[0],
                         ms=time_ms(lambda: G._tgmm_cuda(lhs, dout, tile_group, e, **kw)),
                         plain_ms=time_ms(lambda: G._tgmm_plain(lf, df, tile_group, e, **kw)),
                         bound=bound(moved, flops, rate), library_ms=lib_ms["tgmm"]),
        }
        for name, r in res.items():
            lib_text = "null" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
            print(f"time {name} [{tag}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
                  f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
                  f"{lib_text} (torch._grouped_mm)", flush=True)
        return res

    e = MOE_EXPERTS
    dst, tile_group, m = routed(MOE_TOKENS, e)
    check(m == 9216 and tile_group.numel() == 72, f"layout of 8192 pairs: m_pad {m}")
    main = case(f"gate/up m{m} k{MOE_D} n{MOE_F}", dst, tile_group, m, e, MOE_D, MOE_F,
                timed=True)
    case(f"down m{m} k{MOE_F} n{MOE_D}", dst, tile_group, m, e, MOE_F, MOE_D, timed=True)
    dst, tile_group, m = routed(MOE_TOKENS, e, skip=(3,))
    case(f"empty expert 3, m{m} k{MOE_D} n{MOE_F}", dst, tile_group, m, e, MOE_D, MOE_F,
         empty=(3,))
    one = torch.full((8,), 2, dtype=torch.int32, device="cuda")
    case("one expert owns every tile, m1024 k256 n384", None, one, 1024, e, 256, 384,
         empty=tuple(x for x in range(e) if x != 2))
    dst, tile_group, m = routed(300, 4)
    case(f"ragged widths m{m} k72 n200", dst, tile_group, m, 4, 72, 200)
    case(f"mixtral-tiny m{m} k64 n128", dst, tile_group, m, 4, 64, 128)
    case(f"mixtral-tiny down m{m} k128 n64", dst, tile_group, m, 4, 128, 64)
    case(f"float32 m{m} k72 n200", dst, tile_group, m, 4, 72, 200, dtype=torch.float32)
    dst, tile_group, m = routed(1024, e, skip=(0, 7))
    case(f"float32, empty experts 0 and 7, m{m} k256 n512", dst, tile_group, m, e, 256, 512,
         dtype=torch.float32, empty=(0, 7))
    dst, tile_group, m = routed(1024, e, block_m=256)
    case(f"block_m 256, m{m} k256 n384", dst, tile_group, m, e, 256, 384, block_m=256)
    # Ids past the last expert (never made by the layout) read as E - 1 in
    # K4 and in its plain version; K5's plain version takes no such id.
    past = torch.tensor([0, e, 3, e + 1, 100, e - 1, 2, e], dtype=torch.int32, device="cuda")
    case(f"tile ids {past.tolist()} over {e} experts, m1024 k256 n384", None, past, 1024, e,
         256, 384, k5=False)
    return {"gmm": main["gmm"], "tgmm": main["tgmm"]}


def phase_moe_dispatch(M, card):
    """One mixtral-small layer in float32: the "gmm" dispatch against the
    "ragged" oracle on the same weights and tokens (one layer, so both
    route the same tokens to the same experts)."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.llama import causal_lm_loss
    from ray_tpu_torch.models.mixtral import MixtralForCausalLM

    base = replace(M.CONFIGS["mixtral-small"], num_layers=1, dtype=torch.float32)
    ids = torch.randint(0, base.vocab_size, (1, 512), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    results = []
    for dispatch in ("gmm", "ragged"):
        model = MixtralForCausalLM(replace(base, moe_dispatch=dispatch), device="cuda")
        logits = model(ids)
        causal_lm_loss(logits, torch.roll(ids, -1, dims=1)).backward()
        results.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (lg, gg), (lr, gr) = results
    errs = [assert_close("MoE gmm logits", lg, lr, F32_TOL, F32_TOL, F32_TOL)]
    for name, g in gr.items():
        # Each gradient as one row: its normwise error over the whole tensor.
        # Element-wise, an entry that cancels to near zero keeps the error of
        # its terms, so the atol scales with the largest entry.
        errs.append(assert_close(f"MoE gmm grad {name}", gg[name].reshape(1, -1),
                                 g.reshape(1, -1), F32_TOL * float(g.abs().max()),
                                 F32_TOL, F32_TOL, tile=1))
    print(f"MoE dispatch [mixtral-small, 1 layer, b1 s512, float32]: gmm against ragged, "
          f"logits and {len(gr)} grads: {fmt(worst(*errs))}; limit rel {F32_TOL}: ok",
          flush=True)


def phase_mixtral(A, G, M, card, bench_model, peak):
    """The Mixtral path at full width and depth, counted from zero; returns
    its launches."""
    import torch
    from dataclasses import replace

    cfg = replace(M.CONFIGS["mixtral-small"], param_dtype=torch.bfloat16, moe_dispatch="gmm")
    model = M.MixtralForCausalLM(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    G.reset_launch_counts()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, peak, loss_fn=M.moe_lm_loss,
                    n_params=cfg.active_params_per_token())
    launches = {**A.LAUNCHES, **G.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"Mixtral loss not finite: {losses}")
    check(losses[-1] < losses[0], f"Mixtral loss did not fall: {losses}")
    steps, n = TIMED_STEPS + 1, cfg.num_layers
    # remat "dots" checkpoints each layer. Forward: K1 once, K4 three times
    # (gate, up, down). Backward of a layer: its recompute runs the forward
    # again up to the last tensor it saved, which comes after the down
    # projection, so K1 and K4 x3 again; then K2 and K3 once, and for each
    # of the three projections K4 (dlhs) and K5 (drhs). Per layer and step:
    # K1 2, K2 1, K3 1, K4 9, K5 3 (counted on the CPU by the tests too).
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                "gmm": 9 * n, "tgmm": 3 * n}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"Mixtral: {name} launched {launches[name]} times in {steps} steps, "
              f"expected {k * steps}")
    print(f"train mixtral-small (8 layers, 8 experts, top-2, gmm) b{BATCH} s{SEQ} bf16 on "
          f"{card}: losses {[round(x, 4) for x in losses]}, {r['tokens_per_s']:.1f} "
          f"tokens/s, step {r['step_ms']:.1f} ms, MFU over active params "
          f"{r['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)
    return launches


def phase_probe(M):
    """`resolve_moe_dispatch` on the card, its disk cache under a
    temporary HOME; prints the pick and both times."""
    import torch
    from dataclasses import replace

    cfg = replace(M.CONFIGS["mixtral-small"], param_dtype=torch.bfloat16)
    saved = {k: os.environ.get(k) for k in ("HOME", "RAY_TPU_MOE_DISPATCH")}
    with tempfile.TemporaryDirectory() as home:
        os.environ["HOME"] = home
        os.environ.pop("RAY_TPU_MOE_DISPATCH", None)
        M._RESOLVED.clear()
        try:
            pick = M.resolve_moe_dispatch(cfg, tokens=BATCH * SEQ)
            cached = os.path.exists(M._cache_path())
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    check(cached, "resolve_moe_dispatch did not write its disk cache")
    (seconds,) = M.PROBE_SECONDS.values()
    print(f"dispatch probe [mixtral-small widths, {BATCH * SEQ} tokens, median of "
          f"{M.PROBE_REPEATS} rounds of 10 steps]: picks {pick}; capacity {seconds['capacity'] * 1e3:.3f} ms, gmm "
          f"{seconds['gmm'] * 1e3:.3f} ms per forward + backward (capacity wins only "
          f"below {1 - M.PROBE_MARGIN:g} of gmm)", flush=True)


def phase_long_kernels(A):
    """K1-K3 at the two shapes this slice adds: the long-context sweep's
    (llama-1b at batch 1, 16 heads of 128, T 8192-32768; held on a subset
    of heads where the plain versions' score matrices of every head would
    not fit, timed on all 16) and GPT's (gpt2-large at batch 4: 80 heads
    of 64, T 1024, plain multi-head attention)."""
    import torch

    case, _ = attention_cases(A, seed=3)
    for bh, t, held in LONG_ATTN:
        case(bh, t, t, 128, True, timed=True, check_bh=held)
        torch.cuda.empty_cache()
    case(**GPT_ATTN, timed=True)
    torch.cuda.empty_cache()


def phase_gpt(A, card, bench_model, peak):
    """GPT on the card: a 2-layer model at gpt2-large's widths against the
    same weights on the CPU's plain path (bf16 logits and loss), then
    gpt2-large at full width and depth trained from zero counts."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.gpt import CONFIGS as GPT_CONFIGS
    from ray_tpu_torch.models.gpt import GPTForCausalLM
    from ray_tpu_torch.models.llama import causal_lm_loss

    base = GPT_CONFIGS["gpt2-large"]
    small = replace(base, num_layers=2)
    ids = torch.randint(0, base.vocab_size, (1, 256),
                        generator=torch.Generator().manual_seed(4))
    targets = torch.roll(ids, -1, dims=1)
    on_card = GPTForCausalLM(small, device="cuda")
    on_cpu = GPTForCausalLM(small, device="cpu")
    on_cpu.load_state_dict(on_card.state_dict())
    with torch.no_grad():
        got = on_card(ids.cuda()).float().cpu()
        want = on_cpu(ids).float()
    loss_got, loss_want = (float(causal_lm_loss(x, targets)) for x in (got, want))
    rel = float((got - want).norm() / want.norm())
    check(bool(torch.isfinite(got).all()) and rel <= GPT_LOGITS_REL
          and abs(loss_got - loss_want) <= GPT_LOGITS_REL * abs(loss_want),
          f"GPT logits on the card vs the CPU: normwise {rel:.3e}, loss {loss_got} vs "
          f"{loss_want} (limit {GPT_LOGITS_REL})")
    print(f"GPT [gpt2-large widths, 2 layers, b1 s256, bf16]: logits on the card vs the "
          f"CPU plain path normwise {rel:.2e}, loss {loss_got:.5f} vs {loss_want:.5f}; "
          f"limit {GPT_LOGITS_REL}: ok", flush=True)
    del on_card, on_cpu
    torch.cuda.empty_cache()

    model = GPTForCausalLM(base, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    r = bench_model(model, GPT_BATCH, GPT_SEQ, TIMED_STEPS, peak)
    launches = dict(A.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"GPT loss not finite: {losses}")
    check(losses[-1] < losses[0], f"GPT loss did not fall: {losses}")
    steps, n = TIMED_STEPS + 1, base.num_layers
    # remat: K1 in each block's forward and again in its recompute; K2
    # and K3 once per block in backward.
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"GPT: {name} launched {launches[name]} times in {steps} steps, "
              f"expected {k * steps}")
    print(f"train gpt2-large (36 layers, 20 heads of 64, f32 params, bf16 compute, remat) "
          f"b{GPT_BATCH} s{GPT_SEQ} on {card}: losses {[round(x, 4) for x in losses]}, "
          f"{r['tokens_per_s']:.1f} tokens/s, step {r['step_ms']:.1f} ms, MFU "
          f"{r['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)


def phase_longctx(A, card, peak):
    """The bench's long-context sweep (`ray_tpu_torch.bench.longctx_sweep`)
    as `python -m ray_tpu_torch.bench` runs it: llama-1b, bf16
    parameters, batch 1, T 8192, 16384 and 32768, 5 timed steps each with
    the chunked loss; a later point may be recorded as out of memory."""
    import torch
    from dataclasses import replace

    from ray_tpu_torch.bench import LONGCTX_SEQS, longctx_sweep
    from ray_tpu_torch.models.llama import CONFIGS

    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    seqs = [int(x) for x in LONGCTX_SEQS.split(",")]
    A.reset_launch_counts()
    out = longctx_sweep(cfg, LONGCTX_BENCH_STEPS, peak, torch.device("cuda"), seqs)
    launches = dict(A.LAUNCHES)
    points = out["longctx"]
    ran = [p for p in points if "oom" not in p]
    check(len(points) == len(seqs) or "oom" in points[-1],
          f"long-context sweep stopped early without an OOM: {points}")
    for p in points:
        if "oom" in p:
            print(f"longctx llama-1b b1 s{p['seq']} on {card}: {p['oom']} (recorded; "
                  "the sweep ends here)", flush=True)
            continue
        check(math.isfinite(p["loss"]), f"long-context loss not finite: {p}")
        print(f"longctx llama-1b b1 s{p['seq']} bf16 on {card}: loss {p['loss']:.4f}, "
              f"{p['tokens_per_s']:.1f} tokens/s, step {p['step_ms']:.1f} ms, MFU "
              f"{p['mfu']:.4f} of {peak:.3g} FLOP/s, peak memory "
              f"{p['peak_memory_gb']:.2f} GB", flush=True)
    check(out["longctx_seq"] == seqs[0] and out["longctx_mfu"] == ran[0]["mfu"],
          f"long-context headline is not the first point's: {out}")
    # remat "nothing": per layer and step K1 twice, K2 and K3 once; a
    # point that ran out of memory launched some before it stopped.
    steps, n = max(5, LONGCTX_BENCH_STEPS // 2) + 1, cfg.num_layers
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}
    for name, k in per_step.items():
        want = k * steps * len(ran)
        ok = launches[name] == want if len(ran) == len(points) else launches[name] >= want
        check(ok, f"long-context sweep: {name} launched {launches[name]} times, expected "
                  f"{want} over {len(ran)} points of {steps} steps")
    print(f"longctx sweep: {len(ran)} points measured, headline s{out['longctx_seq']} "
          f"MFU {out['longctx_mfu']:.4f}; launches {launches}", flush=True)


def phase_ring_blocks(A):
    """K1-K3 as the ring runs them on one rank: a block without the causal
    mask at T 8192, held and timed as in phase 10;
    then the diagonal block (causal) and an earlier block of the same
    queries, merged as `ring_attention` merges them, against the plain
    attention over both blocks' keys, and K2 + K3 on each block given the
    merged (global) o and lse, against their plain versions on the same
    inputs. The plain versions are held on HELD heads, where their float32
    scores over both blocks fit beside the kernels' inputs."""
    import torch

    from ray_tpu_torch.ops.ring_attention import _merge

    case, rand = attention_cases(A, seed=5)
    bh, t, d, held = RING_HEADS, RING_SEQ // RING_RANKS, RING_D, 4
    case(bh, t, t, d, False, timed=True)
    torch.cuda.empty_cache()

    q, do = rand(bh, t, d), rand(bh, t, d)
    (k_diag, v_diag), (k_prev, v_prev) = (rand(bh, t, d), rand(bh, t, d)), \
        (rand(bh, t, d), rand(bh, t, d))
    scale = 1.0 / math.sqrt(d)
    o_d, lse_d = A._flash_fwd_cuda(q, k_diag, v_diag, causal=True, sm_scale=scale)
    o_p, lse_p = A._flash_fwd_cuda(q, k_prev, v_prev, causal=False, sm_scale=scale)
    o, lse = _merge(o_d, lse_d, o_p, lse_p)
    o = o.to(q.dtype)
    # The plain attention over [earlier block, diagonal block]: the
    # end-aligned causal mask lets each query see the whole earlier block
    # and the diagonal block up to itself.
    f = [x[:held].float() for x in (q, k_prev, k_diag, v_prev, v_diag, do)]
    qf, kpf, kdf, vpf, vdf, dof = f
    o_ref, lse_ref = A._flash_fwd_plain(qf, torch.cat([kpf, kdf], 1), torch.cat([vpf, vdf], 1),
                                        causal=True, sm_scale=scale)
    errs = [assert_close("ring merge o", o[:held], o_ref, O_TOL, O_TOL, REL_TOL),
            assert_close("ring merge lse", lse[:held], lse_ref, LSE_ATOL, 0.0)]
    # K2 and K3 take the plain merged lse and delta on the held heads
    # (the merged kernels' elsewhere), so each block is held on identical
    # inputs; over a block a row's p sums to less than 1.
    delta_ref = (dof * o_ref).sum(-1)
    lse_in = torch.cat([lse_ref, lse[held:]])
    delta = torch.cat([delta_ref, (do[held:].float() * o[held:].float()).sum(-1)])
    blocks = (("diagonal", k_diag, v_diag, kdf, vdf, True),
              ("earlier", k_prev, v_prev, kpf, vpf, False))
    for name, k, v, kf, vf, causal in blocks:
        kw = dict(causal=causal, sm_scale=scale)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, do, lse_in, delta, **kw)
        dq = A._flash_bwd_dq_cuda(q, k, v, do, lse_in, delta, **kw)
        dk_p, dv_p = A._flash_bwd_dkv_plain(qf, kf, vf, dof, lse_ref, delta_ref, **kw)
        dq_p = A._flash_bwd_dq_plain(qf, kf, vf, dof, lse_ref, delta_ref, **kw)
        torch.cuda.synchronize()
        errs += [assert_close(f"ring {name} block K2 dk", dk[:held], dk_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL),
                 assert_close(f"ring {name} block K2 dv", dv[:held], dv_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL),
                 assert_close(f"ring {name} block K3 dq", dq[:held], dq_p, GRAD_TOL, GRAD_TOL,
                              REL_TOL)]
        del dk, dv, dq, dk_p, dv_p, dq_p
    print(f"ring blocks [bh{bh} t{t} d{d}, two blocks merged, held on {held} heads]: merged o "
          f"and lse against the plain attention over both blocks, K2 and K3 given the "
          f"global (o, lse) on each block: {fmt(worst(*errs))}; limit rel {REL_TOL}: ok",
          flush=True)
    torch.cuda.empty_cache()


def phase_ring(A, card):
    """Ring attention and the sequence-parallel llama-1b step over
    RING_RANKS processes sharing the card, through `parallel.launch`."""
    import functools
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, chunked_causal_lm_loss
    from ray_tpu_torch.parallel.launch import ring_inputs, run_llama_train, run_ring, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    n, t, h, d = RING_RANKS, RING_SEQ, RING_HEADS, RING_D
    spec = MeshSpec(seq=n)
    # (a) ring attention against single-card flash_attention on the same tensors
    inputs = (6, 1, h, h, t, d)
    q, k, v, do = (torch.from_numpy(x).to("cuda", torch.bfloat16) for x in ring_inputs(*inputs))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = A.flash_attention(*leaves, causal=True)
    o.backward(do)
    want = {name: x.detach().cpu() for name, x in
            zip(("o", "dq", "dk", "dv"), (o, *(x.grad for x in leaves)))}
    del q, k, v, do, leaves, o
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(run_ring, n, spec, [dict(inputs=inputs, causal=True, dtype="bfloat16")],
                deadline_s=300)
    seconds = time.perf_counter() - t0
    parts = sorted((r[0] for r in res), key=lambda r: r["seq_rank"])
    for r in parts:
        print(f"ring rank {r['seq_rank']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}); launches {r['launches']}", flush=True)
    errs = []
    for name in ("o", "dq", "dk", "dv"):
        got = torch.cat([r[name] for r in parts], dim=2).float()
        tol = O_TOL if name == "o" else GRAD_TOL
        errs.append(assert_close(f"ring {name} vs single-card", got, want[name].float(), tol, tol,
                                 REL_TOL))
    launches = {name: sum(r["launches"][name] for r in parts) for name in A.LAUNCHES}
    blocks = n * (n + 1) // 2  # rank r runs r + 1 blocks
    check(launches == {"flash_fwd": blocks, "flash_bwd_dkv": blocks, "flash_bwd_dq": blocks},
          f"ring launches {launches}, expected {blocks} of each")
    print(f"ring attention [{n} ranks on one card, b1 h{h} T {t} (shards of {t // n}) d{d} "
          f"bf16 causal]: o, dq, dk, dv against single-card flash_attention {fmt(worst(*errs))}; "
          f"limit rel {REL_TOL}; launches over the ranks {launches}; world of {n} "
          f"processes in {seconds:.1f} s: ok", flush=True)
    del want

    # (b) the sequence-parallel llama-1b train steps against the same
    # steps on one card, from the same weights and ids
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, t))
    loss_fn = functools.partial(chunked_causal_lm_loss, chunk_size=RING_CHUNK)
    model = LlamaForCausalLM(cfg, device="cuda")
    optimizer = make_optimizer(model)
    ids_c = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    targets_c = torch.roll(ids_c, -1, 1)
    single, single_s = timed_steps(
        lambda: train_step(model, optimizer, ids_c, targets_c, loss_fn), RING_TIMED_STEPS)
    del model, optimizer, ids_c, targets_c
    torch.cuda.empty_cache()
    res = spawn(run_llama_train, n, spec, cfg, ids, RING_TIMED_STEPS, loss_fn, deadline_s=600)
    losses = res[0]["losses"]
    digests = [r["param_digest"] for r in res]
    check(all(x == digests[0] for x in digests),
          f"ranks hold different parameters after the steps: digests {digests}")
    check(all(math.isfinite(x) for x in losses), f"sequence-parallel loss not finite: {losses}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    check(max(loss_rel) <= RING_LOSS_RTOL,
          f"sequence-parallel losses {losses} vs single-card {single}: relative "
          f"{loss_rel} (rtol {RING_LOSS_RTOL})")
    check(losses[-1] < losses[0], f"sequence-parallel loss did not fall: {losses}")
    launches = {name: sum(r["launches"][name] for r in res) for name in A.LAUNCHES}
    steps, layers = RING_TIMED_STEPS + 1, cfg.num_layers
    # remat "nothing": each layer's ring forward runs twice (forward and
    # recompute), its backward once; each pass launches `blocks` kernels
    # over the ranks.
    per_step = {"flash_fwd": 2 * layers * blocks, "flash_bwd_dkv": layers * blocks,
                "flash_bwd_dq": layers * blocks}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"sequence-parallel step: {name} launched {launches[name]} times over the ranks "
              f"in {steps} steps, expected {k * steps}")
    step_ms = max(r["step_ms"] for r in res)
    for r in sorted(res, key=lambda r: r["seq_rank"]):
        print(f"seq-parallel rank {r['seq_rank']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}), step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"train llama-1b seq-parallel (seq {n}, b1, T {t}, bf16, chunked loss) on {card}, "
          f"{n} ranks sharing the card over gloo through host memory: losses "
          f"{losses} against single-card {single} (relative {max(loss_rel):.2e}, rtol "
          f"{RING_LOSS_RTOL}), parameters equal on every rank, step {step_ms:.1f} ms "
          f"(slowest rank; one card alone {single_s / RING_TIMED_STEPS * 1e3:.1f} ms), "
          f"{t / step_ms * 1e3:.1f} "
          f"tokens/s, launches over the ranks {launches} ({per_step} per step): ok; not a "
          f"measure of scaling (one card, host-staged exchange)", flush=True)
    print("FSDP and tensor parallelism (parallel.mesh.shard_params) are not run: on one card "
          "gloo has no all-gather or reduce-scatter of CUDA tensors and NCCL refuses two "
          "ranks on a card; they run in the CPU tests over gloo", flush=True)


def _grad_rows(g):
    """A gradient as rows for `rel_errs`: [out, in] weights by output row
    (tiles of TILE), a vector as one row (tile 1)."""
    return (g.reshape(-1, g.shape[-1]), TILE) if g.dim() > 1 else (g.reshape(1, -1), 1)


def phase_pipeline(A, card):
    """llama-1b's decoder layers as a pipeline of PIPE_STAGES ranks sharing
    the card, against the same layers in sequence on one card."""
    import numpy as np
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.parallel.launch import run_pipeline_llama, sequential_llama, spawn

    s_count, layers, m_count = PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    check(s_count * layers == cfg.num_layers, "the pipeline must hold every layer")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (m_count, 1, SEQ))
    want = sequential_llama(cfg, s_count, layers, ids, TIMED_STEPS, PIPE_LR, device="cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sorted(spawn(run_pipeline_llama, s_count, cfg, layers, ids, TIMED_STEPS, PIPE_LR,
                       deadline_s=600), key=lambda r: r["stage"])
    seconds = time.perf_counter() - t0
    errs = []
    for r in res:
        errs.append(assert_close(f"pipeline y (stage {r['stage']}) vs sequential",
                                 r["y"].float(), want["y"].float(), O_TOL, O_TOL, REL_TOL))
        grads = want["grads"][r["stage"]]
        check(set(r["grads"]) == set(grads), f"stage {r['stage']}: other parameters")
        for name, w in grads.items():
            (got, tile), (ref, _) = _grad_rows(r["grads"][name].float()), _grad_rows(w.float())
            errs.append(assert_close(f"pipeline grad {name} (stage {r['stage']})", got, ref,
                                     GRAD_TOL * float(ref.abs().max()), GRAD_TOL, REL_TOL,
                                     tile=tile))
    steps = TIMED_STEPS + 1
    for r in res:
        losses = r["losses"]
        check(all(math.isfinite(x) for x in losses), f"pipeline loss not finite: {losses}")
        check(losses[-1] < losses[0], f"pipeline loss did not fall: {losses}")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
        check(max(loss_rel) <= RING_LOSS_RTOL,
              f"pipeline losses {losses} vs sequential {want['losses']}: relative {loss_rel} "
              f"(rtol {RING_LOSS_RTOL})")
        # Each rank runs its 11 layers on the M microbatches of its own
        # ticks only: K1 in the forward and again in remat "nothing"'s
        # recompute inside the backward's VJP, K2 and K3 once.
        per_step = {"flash_fwd": 2 * m_count * layers, "flash_bwd_dkv": m_count * layers,
                    "flash_bwd_dq": m_count * layers}
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"pipeline stage {r['stage']}: {name} launched {r['launches'][name]} times "
                  f"in {steps} steps, expected {k * steps}")
        print(f"pipeline stage {r['stage']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}), step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB, launches {r['launches']}", flush=True)
    step_ms = max(r["step_ms"] for r in res)
    print(f"pipeline llama-1b (22 layers as {s_count} stages of {layers}, {m_count} "
          f"microbatches of b1 s{SEQ}, bf16, SGD {PIPE_LR} on mean(y^2)) on {card}, "
          f"{s_count} ranks sharing the card over gloo through host memory: y and "
          f"{sum(len(g) for g in want['grads'])} grads against the layers in sequence "
          f"{fmt(worst(*errs))}, limit rel {REL_TOL}; losses {res[0]['losses']} against "
          f"{want['losses']} (rtol {RING_LOSS_RTOL}); step {step_ms:.1f} ms (slowest rank; "
          f"one card in sequence {want['step_ms']:.1f} ms), peak memory per rank "
          f"{[round(r['peak_memory_gb'], 2) for r in res]} GB; bubble share "
          f"(S-1)/(M+S-1) = {(s_count - 1) / (m_count + s_count - 1):.2f} (the schedule's, "
          f"not measured); launches per rank {per_step} per step; world in {seconds:.1f} s: "
          f"ok; not a measure of scaling (one card, host-staged exchange)", flush=True)


def phase_expert(A, card):
    """mixtral-small on data x expert over ranks sharing the card, against
    the same steps on one card with "capacity"."""
    import numpy as np
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.mixtral import CONFIGS, MixtralForCausalLM, moe_lm_loss
    from ray_tpu_torch.parallel.launch import run_mixtral_train, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    spec = MeshSpec(data=EXPERT_DATA, expert=EXPERT_EP)
    cfg = replace(CONFIGS["mixtral-small"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, SEQ))
    model = MixtralForCausalLM(replace(cfg, moe_dispatch="capacity"), device="cuda")
    optimizer = make_optimizer(model)
    ids_c = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    targets_c = torch.roll(ids_c, -1, 1)
    single, single_s = timed_steps(
        lambda: train_step(model, optimizer, ids_c, targets_c, moe_lm_loss), TIMED_STEPS)
    del model, optimizer, ids_c, targets_c
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(run_mixtral_train, spec.num_devices, spec, cfg, ids, TIMED_STEPS,
                deadline_s=900)
    seconds = time.perf_counter() - t0
    losses = res[0]["losses"]
    check(all(r["losses"] == losses for r in res), "ranks report different losses")
    check(all(math.isfinite(x) for x in losses), f"expert-parallel loss not finite: {losses}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    check(max(loss_rel) <= RING_LOSS_RTOL,
          f"expert-parallel losses {losses} vs single-card {single}: relative {loss_rel} "
          f"(rtol {RING_LOSS_RTOL})")
    check(losses[-1] < losses[0], f"expert-parallel loss did not fall: {losses}")
    for r in res:
        pair = [p["param_digest"] for p in res if p["expert_rank"] == r["expert_rank"]]
        check(all(d == r["param_digest"] for d in pair),
              f"the ranks of expert {r['expert_rank']}'s data pair differ: {pair}")
        check(r["replicated_digest"] == res[0]["replicated_digest"],
              "the parameters that are not experts differ between ranks")
    launches = {name: sum(r["launches"][name] for r in res) for name in A.LAUNCHES}
    steps, layers = TIMED_STEPS + 1, cfg.num_layers
    # Each rank runs every layer's attention on its data replica's row:
    # under remat "dots" K1 in the forward and again in the recompute, K2
    # and K3 once.
    ranks = spec.num_devices
    per_step = {"flash_fwd": 2 * layers * ranks, "flash_bwd_dkv": layers * ranks,
                "flash_bwd_dq": layers * ranks}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"expert-parallel step: {name} launched {launches[name]} times over the ranks "
              f"in {steps} steps, expected {k * steps}")
    step_ms = max(r["step_ms"] for r in res)
    for r in sorted(res, key=lambda r: (r["data_rank"], r["expert_rank"])):
        print(f"expert rank {r['expert_rank']} of data replica {r['data_rank']}: backend "
              f"{r['backend']}, {r['device']} ({r['card']}), step {r['step_ms']:.1f} ms, peak "
              f"memory {r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"train mixtral-small expert-parallel (data {EXPERT_DATA} x expert {EXPERT_EP}, "
          f"{cfg.num_experts // EXPERT_EP} experts a rank, b{BATCH} s{SEQ}, bf16, remat dots, "
          f"capacity) on {card}, {ranks} ranks sharing the card over gloo through host "
          f"memory: losses {losses} against single-card capacity {single} (relative "
          f"{max(loss_rel):.2e}, rtol {RING_LOSS_RTOL}), data pairs equal, replicated "
          f"parameters equal on every rank, step {step_ms:.1f} ms (slowest rank; one card "
          f"alone {single_s / TIMED_STEPS * 1e3:.1f} ms), launches over the ranks {launches} "
          f"({per_step} per step); world in {seconds:.1f} s: ok; not a measure of scaling "
          f"(one card, host-staged exchange)", flush=True)
    print("the dense four-axis dryrun (ray_tpu_torch.dryrun: data x fsdp x seq x tensor) and "
          "dryrun_multichip are not run: on one card gloo has no all-gather or reduce-scatter "
          "of CUDA tensors and NCCL refuses two ranks on a card; both run in the CPU tests "
          "over gloo", flush=True)


def _bitwise_checksum(t):
    """A checksum of a bf16 tensor's bits, computed where the tensor lies:
    each 16-bit word weighted by its position, so a moved word counts."""
    import torch

    words = t.reshape(-1).view(torch.int16).to(torch.int64)
    weights = torch.arange(words.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int((words * weights).sum())


def phase_object_plane(card):
    """The runtime on the card: GPU detection, a bf16 CUDA tensor through
    the object store to a one-GPU actor and another back, and a CPU task
    that sees no card."""
    import torch

    import ray_tpu_torch as rt

    rt.init()
    resources = rt.cluster_resources()
    print(f"runtime resources: {resources}", flush=True)
    check(resources.get("GPU") == 1.0, f"the runtime detected {resources.get('GPU')} GPUs")

    n = OBJECT_MIB * 1024 * 1024 // 2
    gb = OBJECT_MIB * 1024 * 1024 / 1e9
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(17),
                    device="cuda", dtype=torch.bfloat16)
    want = _bitwise_checksum(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rt.put(x)
    put_s = time.perf_counter() - t0

    @rt.remote(num_gpus=1)
    class OnCard:
        def take(self, refs):
            import os
            import time

            import torch

            t0 = time.perf_counter()
            host = rt.get(refs[0])
            get_s = time.perf_counter() - t0
            on_card = host.cuda()
            return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.get_device_name(),
                    str(on_card.device), _bitwise_checksum(on_card), get_s)

        def give(self):
            import time

            import torch

            y = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(18),
                            device="cuda", dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(y)
            put_s = time.perf_counter() - t0
            return [ref], y.cpu(), put_s

    actor = OnCard.remote()
    visible, name, device, got, actor_get_s = rt.get(actor.take.remote([ref]), timeout=300)
    check(visible == "0", f"the GPU actor sees CUDA_VISIBLE_DEVICES={visible!r}")
    check(name == torch.cuda.get_device_name(0), f"the GPU actor sees {name}")
    check(got == want, f"the actor's checksum {got} of the driver's tensor != {want}")
    (back_ref,), host_copy, actor_put_s = rt.get(actor.give.remote(), timeout=300)
    t0 = time.perf_counter()
    back = rt.get(back_ref, timeout=300)
    get_s = time.perf_counter() - t0
    check(back.device.type == "cpu" and back.dtype == torch.bfloat16
          and back.shape == host_copy.shape, "the actor's tensor came back changed")
    check(torch.equal(back.view(torch.int16), host_copy.view(torch.int16)),
          "the actor's CUDA tensor is not bitwise equal after put/get")
    rt.kill(actor)

    @rt.remote
    def no_card():
        import os

        import torch

        return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count()

    seen = rt.get(no_card.remote(), timeout=300)
    check(seen == ("", 0), f"a task without num_gpus sees {seen}")
    print(f"object plane on {card}: GPU actor on {device} of {name} "
          f"(CUDA_VISIBLE_DEVICES={visible}), {OBJECT_MIB} MiB bf16 bitwise equal both ways; "
          f"driver put from the card {put_s * 1e3:.1f} ms ({gb / put_s:.2f} GB/s), actor get "
          f"{actor_get_s * 1e3:.1f} ms ({gb / actor_get_s:.2f} GB/s), actor put from its card "
          f"{actor_put_s * 1e3:.1f} ms ({gb / actor_put_s:.2f} GB/s), driver get "
          f"{get_s * 1e3:.1f} ms ({gb / get_s:.2f} GB/s); a task without num_gpus sees "
          f"CUDA_VISIBLE_DEVICES='' and 0 devices: ok", flush=True)


def trainer_loop(config):
    """phase_trainer's loop, in a GPU worker of the runtime: phase 5's
    llama-1b train through bench_model, then a checkpoint of the model."""
    import os
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, causal_lm_loss
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    A.reset_launch_counts()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    launches = dict(A.LAUNCHES)
    for step, loss in enumerate(r["losses"]):
        train.report({"step": step, "loss": loss})
    d = tempfile.mkdtemp(dir=config["scratch"])
    save_s = time.perf_counter()
    train.save_pytree(os.path.join(d, "model"), model.state_dict())
    save_s = time.perf_counter() - save_s
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (BATCH, SEQ)),
                          dtype=torch.long, device="cuda")
    with torch.no_grad():
        fixed = float(causal_lm_loss(model(ids), torch.roll(ids, -1, dims=1)))
    train.report({"fixed_loss": fixed, "step_ms": r["step_ms"], "launches": launches,
                  "card": torch.cuda.get_device_name(), "save_s": save_s,
                  "visible": os.environ.get("CUDA_VISIBLE_DEVICES")},
                 checkpoint=train.Checkpoint(d))


def phase_trainer(A, card, in_process):
    """TorchTrainer at llama-1b on one GPU worker, held against phase 5's
    in-process run (`in_process`), and its checkpoint reloaded here."""
    import shutil
    from dataclasses import replace

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, causal_lm_loss

    scratch = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        t0 = time.perf_counter()
        result = train.TorchTrainer(
            trainer_loop, train_loop_config={"scratch": scratch},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(storage_path=os.path.join(scratch, "results")),
        ).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"TorchTrainer failed: {result.error}")
        history = result.metrics_history
        losses = [m["loss"] for m in history if "loss" in m]
        final = history[-1]
        check(len(losses) == TIMED_STEPS + 1, f"the worker reported {len(losses)} losses")
        check(all(math.isfinite(x) for x in losses), f"trainer loss not finite: {losses}")
        check(losses[-1] < losses[0], f"trainer loss did not fall: {losses}")
        steps = TIMED_STEPS + 1
        layers = CONFIGS["llama-1b"].num_layers
        per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
        for name, k in per_step.items():
            check(final["launches"][name] == k * steps,
                  f"trainer: {name} launched {final['launches'][name]} times in {steps} "
                  f"steps, expected {k * steps}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, in_process["losses"])]
        check(max(rel) <= TRAINER_LOSS_RTOL,
              f"trainer losses {losses} vs in-process {in_process['losses']}: relative {rel}")
        check(final["visible"] == "0", f"the train worker sees {final['visible']!r}")

        cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
        fresh = LlamaForCausalLM(cfg, device="cuda")
        t0 = time.perf_counter()
        train.load_pytree(os.path.join(result.checkpoint.path, "model"), fresh.state_dict())
        load_s = time.perf_counter() - t0
        ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (BATCH, SEQ)),
                              dtype=torch.long, device="cuda")
        with torch.no_grad():
            reloaded = float(causal_lm_loss(fresh(ids), torch.roll(ids, -1, dims=1)))
        reload_rel = abs(reloaded - final["fixed_loss"]) / abs(final["fixed_loss"])
        check(reload_rel <= RELOAD_LOSS_RTOL,
              f"reloaded loss {reloaded} vs the worker's {final['fixed_loss']} "
              f"(relative {reload_rel:.2e})")
        print(f"TorchTrainer llama-1b b{BATCH} s{SEQ} bf16, 1 GPU worker on {final['card']} "
              f"(CUDA_VISIBLE_DEVICES={final['visible']}) of {card}: losses "
              f"{[round(x, 4) for x in losses]} against in-process "
              f"{[round(x, 4) for x in in_process['losses']]} (largest relative difference "
              f"{max(rel):.2e}, rtol "
              f"{TRAINER_LOSS_RTOL}), launches {final['launches']} ({per_step} per step); step "
              f"{final['step_ms']:.1f} ms in the worker against {in_process['step_ms']:.1f} ms "
              f"in process (difference {final['step_ms'] - in_process['step_ms']:+.1f} ms); "
              f"checkpoint saved in {final['save_s']:.1f} s, reloaded on the driver's card in "
              f"{load_s:.1f} s: fixed-batch loss {reloaded:.6f} against the worker's "
              f"{final['fixed_loss']:.6f} (relative {reload_rel:.2e}); fit() {fit_s:.1f} s: ok",
              flush=True)
        return final["step_ms"]
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)


def with_targets(batch):
    """Phase 19's map_batches: the ids and `targets = roll(ids, -1)`, in
    numpy, as `bench_model` makes its targets."""
    import numpy as np

    return {"ids": batch["item"], "targets": np.roll(batch["item"], -1, axis=1)}


def data_trainer_loop(config):
    """phase_data_trainer's loop, in a GPU worker of the runtime: phase 5's
    llama-1b steps (a warm-up and TIMED_STEPS timed), each on the next
    batch of `iter_torch_batches` over the Dataset the trainer passed in
    `config["__datasets__"]`; then the host-to-device copy of one batch,
    timed alone."""
    import os
    from dataclasses import replace

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.data.iterator import to_device
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    optimizer = train.make_optimizer(model)
    ds = config["__datasets__"]["train"]
    A.reset_launch_counts()
    losses, waits, devices = [], [], set()
    batches = iter(ds.iter_torch_batches(batch_size=BATCH, dtypes=torch.long))
    t_timed = None
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        waits.append(time.perf_counter() - t0)
        devices.update(str(t.device) for t in batch.values())
        losses.append(train.train_step(model, optimizer, batch["ids"], batch["targets"]))
        if len(losses) == 1:  # the warm-up step, as bench_model's
            float(losses[0])
            t_timed = time.perf_counter()
    float(losses[-1])
    step_ms = (time.perf_counter() - t_timed) / (len(losses) - 1) * 1e3
    launches = dict(A.LAUNCHES)
    host = next(iter(ds.iter_batches(batch_size=BATCH)))
    nbytes = sum(v.nbytes for v in host.values())
    to_device(host, dtypes=torch.long)  # warm the pinned allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(H2D_REPEATS):
        to_device(host, dtypes=torch.long)
    torch.cuda.synchronize()
    h2d_s = (time.perf_counter() - t0) / H2D_REPEATS
    for step, loss in enumerate(losses):
        train.report({"step": step, "loss": float(loss)})
    train.report({"step_ms": step_ms, "launches": launches, "waits_ms": [w * 1e3 for w in waits],
                  "devices": sorted(devices), "h2d_ms": h2d_s * 1e3, "batch_bytes": nbytes,
                  "card": torch.cuda.get_device_name(),
                  "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def phase_data_trainer(card, in_process, trainer_step_ms):
    """Data -> TorchTrainer -> llama-1b: the Dataset built here, every
    step's batch phase 5's, stepped in one GPU worker through
    `iter_torch_batches`; held against phase 5's in-process run."""
    import numpy as np

    from ray_tpu_torch import data as rd
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import CONFIGS

    cfg = CONFIGS["llama-1b"]
    steps = TIMED_STEPS + 1
    # bench_model's batch: the first draw of RandomState(0), every step.
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, SEQ))
    ds = rd.from_numpy([ids] * steps).map_batches(with_targets)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        t0 = time.perf_counter()
        result = train.TorchTrainer(
            data_trainer_loop,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(storage_path=scratch),
            datasets={"train": ds},
        ).fit()
        fit_s = time.perf_counter() - t0
    finally:
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)
    check(result.error is None, f"the Data-fed TorchTrainer failed: {result.error}")
    history = result.metrics_history
    losses = [m["loss"] for m in history if "loss" in m]
    final = history[-1]
    check(len(losses) == steps, f"the worker stepped on {len(losses)} batches, expected {steps}")
    check(final["devices"] == ["cuda:0"], f"the worker's batches lay on {final['devices']}")
    check(all(math.isfinite(x) for x in losses), f"Data-fed loss not finite: {losses}")
    check(losses[-1] < losses[0], f"Data-fed loss did not fall: {losses}")
    layers = cfg.num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    for name, k in per_step.items():
        check(final["launches"][name] == k * steps,
              f"Data-fed trainer: {name} launched {final['launches'][name]} times in "
              f"{steps} steps, expected {k * steps}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, in_process["losses"])]
    check(max(rel) <= TRAINER_LOSS_RTOL,
          f"Data-fed losses {losses} vs in-process {in_process['losses']}: relative {rel}")
    waits = final["waits_ms"]
    print(f"Data -> TorchTrainer llama-1b b{BATCH} s{SEQ} bf16, 1 GPU worker on {final['card']} "
          f"(CUDA_VISIBLE_DEVICES={final['visible']}) of {card}: {steps} batches from "
          f"iter_torch_batches on {final['devices']}; losses {[round(x, 4) for x in losses]} "
          f"against in-process {[round(x, 4) for x in in_process['losses']]} (largest relative "
          f"difference {max(rel):.2e}, rtol {TRAINER_LOSS_RTOL}), launches {final['launches']} "
          f"({per_step} per step); step {final['step_ms']:.1f} ms against {in_process['step_ms']:.1f} "
          f"in process (phase 5) and {trainer_step_ms:.1f} in phase 18's worker; the host's wait "
          f"for each next batch {[round(w, 2) for w in waits]} ms; host-to-device copy of a "
          f"{final['batch_bytes']} B batch {final['h2d_ms']:.3f} ms "
          f"({final['batch_bytes'] / final['h2d_ms'] / 1e6:.3f} GB/s); fit() {fit_s:.1f} s: ok",
          flush=True)


class CollectiveMember:
    """One rank of phase 20's collective group, an actor of the runtime."""

    def __init__(self, rank: int):
        from ray_tpu_torch.util import collective as col

        self.rank = rank
        col.init_collective_group(2, rank, group_name="chip_smoke")

    def where(self):
        import os

        import torch

        return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count(),
                torch.cuda.get_device_name(0))

    def run(self, dtype_name: str):
        """Every op on this rank's COLLECTIVE_MIB tensor on the card, each
        result held against torch's reduction of both ranks' inputs on
        the host (the inputs are made on the host from their seeds)."""
        import torch

        from ray_tpu_torch.util import collective as col

        dtype = getattr(torch, dtype_name)
        n = COLLECTIVE_MIB * 2 ** 20 // torch.empty((), dtype=dtype).element_size()
        inputs = [torch.randn(n, generator=torch.Generator().manual_seed(41 + r)).to(dtype)
                  for r in range(2)]
        x = inputs[self.rank].cuda()
        total = torch.stack(inputs).sum(0)
        want = {"allreduce": total, "allgather": inputs,
                "reducescatter": total.tensor_split(2)[self.rank], "broadcast": inputs[0]}
        calls = {"allreduce": lambda: col.allreduce(x, group_name="chip_smoke"),
                 "allgather": lambda: col.allgather(x, group_name="chip_smoke"),
                 "reducescatter": lambda: col.reducescatter(x, group_name="chip_smoke"),
                 "broadcast": lambda: col.broadcast(x, src_rank=0, group_name="chip_smoke")}
        col.allreduce(x[:1], group_name="chip_smoke")  # the coordinator's first tensor
        out = {}
        for op, call in calls.items():
            col.barrier(group_name="chip_smoke")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got_list = got if isinstance(got, list) else [got]
            want_list = want[op] if isinstance(want[op], list) else [want[op]]
            out[op] = {
                "ms": ms,
                "placed": all(g.device == x.device and g.dtype == dtype for g in got_list),
                "equal": len(got_list) == len(want_list) and all(
                    torch.equal(g.cpu(), w) for g, w in zip(got_list, want_list)),
            }
        return out


def phase_collectives(card):
    """util.collective with CUDA tensors: two actors of num_gpus=0.5 share
    the card; every op on a COLLECTIVE_MIB tensor of bf16 and of float32."""
    import ray_tpu_torch as rt

    member = rt.remote(num_gpus=0.5)(CollectiveMember)
    members = [member.remote(r) for r in range(2)]
    try:
        seen = rt.get([m.where.remote() for m in members], timeout=300)
        check(all(v == "0" and n == 1 for v, n, _ in seen),
              f"the half-GPU members see {seen}")
        for dtype in ("bfloat16", "float32"):
            results = rt.get([m.run.remote(dtype) for m in members], timeout=300)
            for rank, res in enumerate(results):
                for op, r in res.items():
                    check(r["equal"], f"collective {op} of {dtype} on rank {rank} differs from "
                                      "torch's reduction on the host")
                    check(r["placed"], f"collective {op} of {dtype} on rank {rank} did not "
                                       "return on the caller's card and dtype")
            ms = {op: max(res[op]["ms"] for res in results) for op in results[0]}
            print(f"collectives on {card}: 2 actors of num_gpus=0.5 on {seen[0][2]} "
                  f"(CUDA_VISIBLE_DEVICES={seen[0][0]} each), {COLLECTIVE_MIB} MiB of {dtype} "
                  f"a rank, results equal to torch's on the host, on cuda:0 in {dtype}; ms "
                  f"(slower rank) {', '.join(f'{op} {t:.1f}' for op, t in ms.items())}: ok",
                  flush=True)
    finally:
        for m in members:
            rt.kill(m)


def tune_trainer_loop(config):
    """phase_tune's loop, in each trial's GPU worker: phase 5's llama-1b
    steps (`bench_model`'s model, seed, batch and optimizer) at the trial's
    learning rate, K1-K3 counted here."""
    import os
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
    from ray_tpu_torch.ops import attention as A

    started = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    optimizer = train.make_optimizer(model)
    for group in optimizer.param_groups:
        group["lr"] = config["lr"]
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, SEQ)),
                          dtype=torch.long, device="cuda")
    targets = torch.roll(ids, -1, dims=1)
    A.reset_launch_counts()
    losses, dt = train.timed_steps(lambda: train.train_step(model, optimizer, ids, targets),
                                   TUNE_STEPS)
    train.report({"losses": losses, "launches": dict(A.LAUNCHES),
                  "step_ms": dt / TUNE_STEPS * 1e3, "started": started, "ended": time.time(),
                  "card": torch.cuda.get_device_name(),
                  "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def phase_tune(card, in_process):
    """A Tuner over a one-GPU TorchTrainer at llama-1b: two learning rates,
    two trials at once queueing on the card; held against phase 5."""
    import shutil

    import torch

    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models.llama import CONFIGS

    lr = train.make_optimizer(torch.nn.Linear(1, 1)).defaults["lr"]
    scratch = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        t0 = time.time()
        results = tune.Tuner(
            train.TorchTrainer(
                tune_trainer_loop,
                scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
                run_config=train.RunConfig(storage_path=os.path.join(scratch, "trainer"))),
            param_space={"lr": tune.grid_search([lr, TUNE_OTHER_LR])},
            tune_config=tune.TuneConfig(metric="step_ms", mode="min", max_concurrent_trials=2),
            run_config=train.RunConfig(storage_path=scratch, name="tune"),
        ).fit()
        fit_s = time.time() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    check(not results.errors, f"Tune trials failed: {results.errors}")
    trials = sorted((r.metrics for r in results.results), key=lambda m: m["started"])
    check(len(trials) == 2, f"the Tuner ran {len(trials)} trials")
    layers = CONFIGS["llama-1b"].num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    steps = TUNE_STEPS + 1
    want = in_process["losses"][:steps]
    by_lr = {r.config["lr"]: r.metrics for r in results.results}
    for trial_lr, m in by_lr.items():
        losses = m["losses"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"trial at lr {trial_lr}: losses {losses}")
        check(m["visible"] == "0", f"trial at lr {trial_lr}: its worker sees {m['visible']!r}")
        for name, k in per_step.items():
            check(m["launches"][name] == k * steps,
                  f"trial at lr {trial_lr}: {name} launched {m['launches'][name]} times in "
                  f"{steps} steps, expected {k * steps}")
    rel = [abs(a - b) / abs(b) for a, b in zip(by_lr[lr]["losses"], want)]
    check(max(rel) <= TRAINER_LOSS_RTOL,
          f"the trial at phase 5's lr {lr}: losses {by_lr[lr]['losses']} vs phase 5's {want}")
    other = by_lr[TUNE_OTHER_LR]["losses"]
    other_rel = [abs(a - b) / abs(b) for a, b in zip(other[1:], want[1:])]
    check(min(other_rel) > TRAINER_LOSS_RTOL,
          f"the trial at lr {TUNE_OTHER_LR}: losses {other} do not differ from phase 5's {want}")
    wait = trials[1]["started"] - trials[0]["ended"]
    for trial_lr, m in sorted(by_lr.items()):
        print(f"Tune trial lr {trial_lr:g} (1 GPU worker on {m['card']}, "
              f"CUDA_VISIBLE_DEVICES={m['visible']}): losses {[round(x, 4) for x in m['losses']]}"
              f", launches {m['launches']} ({per_step} per step), step {m['step_ms']:.1f} ms, "
              f"its worker's loop {m['ended'] - m['started']:.1f} s, started "
              f"{m['started'] - t0:.1f} s after fit() began", flush=True)
    print(f"Tune llama-1b b{BATCH} s{SEQ} bf16 on {card}: 2 trials, max_concurrent_trials 2, "
          f"queued on the one card; the trial at phase 5's lr {lr:g} against phase 5's losses "
          f"{[round(x, 4) for x in want]} (largest relative difference {max(rel):.2e}, rtol "
          f"{TRAINER_LOSS_RTOL}); the trial at lr {TUNE_OTHER_LR:g} differs after step 0 (by "
          f"{min(other_rel):.2e} at least); the second trial's worker started {wait:.1f} s "
          f"after the first's ended; fit() {fit_s:.1f} s: ok", flush=True)


def cartpole_episodes(steps: int, seed: int):
    """Finished episodes of CartPole-v1's shapes (4 floats an observation,
    2 actions, reward 1) from RandomState(seed), `steps` steps in all:
    phase 22's batches where gymnasium, and so CartPole, is absent."""
    import numpy as np

    from ray_tpu_torch.rllib.env.episode import SingleAgentEpisode

    rng = np.random.RandomState(seed)
    episodes, left = [], steps
    while left:
        length = min(left, int(rng.randint(8, 200)))
        ep = SingleAgentEpisode(initial_observation=rng.randn(4).astype(np.float32))
        for t in range(length):
            ep.add_env_step(rng.randn(4).astype(np.float32), int(rng.randint(2)), 1.0,
                            terminated=t == length - 1,
                            extra_model_outputs={"action_logp": np.float32(-rng.rand())})
        episodes.append(ep.finalize())
        left -= length
    return episodes


def phase_ppo(card):
    """PPO with one learner of one GPU: the learner on the card, its first
    update against a CPU learner's from the same start weights on the same
    batch, then (where gymnasium is installed) the reference test's
    CartPole run."""
    from types import SimpleNamespace

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup, _gpus_per_learner
    from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule, RLModuleSpec

    try:
        import gymnasium  # noqa: F401
        have_env = True
    except ImportError:
        have_env = False
    def settings():
        return (PPOConfig()
                .training(train_batch_size=2000, minibatch_size=128, num_epochs=8, lr=5e-4)
                .debugging(seed=0))

    config = settings().learners(num_learners=1, num_gpus_per_learner=1)
    algo = None
    if have_env:
        config.environment("CartPole-v1").env_runners(num_env_runners=0,
                                                      num_envs_per_env_runner=8)
        algo = config.build()
        group, spec = algo.learner_group, algo._module_spec
        episodes = algo.env_runner_group.sample(num_timesteps=config.train_batch_size)
        source = "sampled by the CPU env runner from CartPole-v1"
    else:
        spec = RLModuleSpec(module_class=DiscretePolicyModule,
                            observation_space=SimpleNamespace(shape=(4,)),
                            action_space=SimpleNamespace(n=2, shape=()))
        group = LearnerGroup(learner_cls=PPOLearner, module_spec=spec,
                             config=config.learner_config())
        episodes = cartpole_episodes(config.train_batch_size, seed=0)
        source = ("built without an env (gymnasium is not installed here): CartPole's shapes "
                  "from RandomState(0)")
    try:
        (learner,) = group._actors
        device = rt.get(learner.device.remote(), timeout=300)
        check(device.startswith("cuda"), f"the PPO learner is on {device}")
        start = group.get_state()

        # The card learner against a CPU learner: same start weights, batch
        # and minibatch permutations (the same numpy seed).
        cpu_config = config.copy().learners(num_gpus_per_learner=0).learner_config()
        cpu = PPOLearner(module_spec=spec, config=cpu_config)
        cpu.build()
        cpu.set_weights(start["params"])
        batch = cpu.build_batch(episodes)
        minibatches = config.num_epochs * (len(batch["obs"]) // config.minibatch_size)
        t0 = time.perf_counter()
        want = cpu.update({k: v.copy() for k, v in batch.items()})
        cpu_ms = (time.perf_counter() - t0) * 1e3 / minibatches
        t0 = time.perf_counter()
        got = group.update_from_batch(batch)
        card_ms = (time.perf_counter() - t0) * 1e3 / minibatches
        check(all(math.isfinite(v) for v in got.values()), f"card learner metrics {got}")
        metric_err = max(abs(got[k] - want[k]) for k in want)
        check(sorted(got) == sorted(want) and metric_err <= PPO_CARD_ATOL,
              f"card learner metrics {got} vs the CPU learner's {want}")
        got_w, want_w = group.get_weights(), cpu.get_weights()
        weight_err = max(float((got_w[k] - want_w[k]).abs().max()) for k in want_w)
        check(weight_err <= PPO_CARD_ATOL,
              f"card learner weights differ from the CPU learner's by {weight_err:.2e}")

        # The default, in this process: num_gpus_per_learner unset puts a
        # local learner on the card, and a learner actor would take one.
        # Its update from the same start on the same batch, then the same
        # with TF32 matmuls: the control PPO_CARD_ATOL must tell apart.
        check(_gpus_per_learner(None, 1) == 1, "a default learner actor asks for no card")

        def default_update(tf32: bool):
            learner = PPOLearner(module_spec=spec, config=settings().learner_config())
            learner.build()
            learner.set_weights(start["params"])
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                out = learner.update({k: v.copy() for k, v in batch.items()})
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
            w = learner.get_weights()
            return (learner.device, max(abs(out[k] - want[k]) for k in want),
                    max(float((w[k] - want_w[k]).abs().max()) for k in want_w))

        default_device, default_metric_err, default_weight_err = default_update(False)
        _, tf32_metric_err, tf32_weight_err = default_update(True)
        check(default_device.type == "cuda",
              f"the default local PPO learner is on {default_device}")
        check(max(default_metric_err, default_weight_err) <= PPO_CARD_ATOL,
              f"the default learner differs from the CPU learner by {default_metric_err:.2e} "
              f"(metrics), {default_weight_err:.2e} (weights)")
        print(f"PPO default learner (num_gpus_per_learner unset) on {default_device}, and a "
              f"learner actor asks for 1 card: from the CPU learner's start weights on its batch, "
              f"largest metric difference {default_metric_err:.2e}, weight difference "
              f"{default_weight_err:.2e} (atol {PPO_CARD_ATOL}); the control with TF32 matmuls: "
              f"metric {tf32_metric_err:.2e}, weight {tf32_weight_err:.2e}: ok", flush=True)
        warm_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = group.update_from_batch(batch)
            warm_ms.append((time.perf_counter() - t0) * 1e3 / minibatches)
            check(all(math.isfinite(v) for v in again.values()), f"card learner metrics {again}")
        print(f"PPO learner on {device} of {card}: one update ({minibatches} minibatches of "
              f"{config.minibatch_size}) from the CPU learner's start weights on its batch of "
              f"{len(batch['obs'])} steps {source}: total_loss {got['total_loss']:.6f} against "
              f"{want['total_loss']:.6f}, largest metric difference {metric_err:.2e}, weight "
              f"difference {weight_err:.2e} (atol {PPO_CARD_ATOL}); ms per minibatch on the card "
              f"{card_ms:.2f} (then {', '.join(f'{x:.2f}' for x in warm_ms)}; each update's round "
              f"trip included), on the CPU {cpu_ms:.2f}: ok", flush=True)
        if not have_env:
            print("PPO CartPole-v1 learning run: not run, gymnasium is not installed on this "
                  "machine (the learner's update was held on batches built without an env)",
                  flush=True)
            return

        # The reference test's learning run, from the start state again.
        group.set_state(start)
        algo.env_runner_group.sync_weights(start["params"])
        runners = algo.env_runner_group
        sample, sample_ms = runners.sample, []

        def timed_sample(**kwargs):
            t0 = time.perf_counter()
            out = sample(**kwargs)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        runners.sample = timed_sample
        best, returns = 0.0, []
        t0 = time.perf_counter()
        for _ in range(PPO_ITERATIONS):
            r = algo.train()
            check(all(math.isfinite(v) for v in r["learners"].values()),
                  f"PPO learner metrics not finite: {r['learners']}")
            returns.append(r["episode_return_mean"])
            best = max(best, r["episode_return_mean"])
            if best >= PPO_THRESHOLD:
                break
        train_s = time.perf_counter() - t0
        check(best >= PPO_THRESHOLD, f"PPO failed to learn CartPole: best={best}")
        print(f"PPO CartPole-v1 (1 learner on {device}, 1 CPU env runner of 8 envs, "
              f"{config.train_batch_size} steps an iteration): episode_return_mean per iteration "
              f"{[round(x, 2) for x in returns]}, best {best:.2f} >= {PPO_THRESHOLD} in "
              f"{len(returns)} of {PPO_ITERATIONS} iterations; sample ms per iteration "
              f"{[round(x, 1) for x in sample_ms]}; {train_s:.1f} s: ok", flush=True)
    finally:
        if algo is not None:
            algo.stop()
        else:
            group.shutdown()


def llama_server():
    """Phase 23's deployment: SERVE_MODEL on the card of its replica (one
    GPU), seed 0, bf16 parameters, as phase 5 builds it. Its
    `@serve.batch` method right-pads a batch of token-id lists to the
    longest and runs the model under `inference_mode`, K1 causal in every
    layer (right padding reaches no real position under the causal
    mask); the LM head runs on each request's last real position only.
    A replica without a card raises."""
    from ray_tpu_torch import serve

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class LlamaServer:
        def __init__(self):
            from dataclasses import replace

            import torch

            from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

            if not torch.cuda.is_available():
                raise RuntimeError("LlamaServer: the replica sees no CUDA card")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            cfg = replace(CONFIGS[SERVE_MODEL], param_dtype=torch.bfloat16)
            self.model = LlamaForCausalLM(cfg, device="cuda")
            self.batches = []

        @serve.batch(max_batch_size=SERVE_MAX_BATCH, batch_wait_timeout_s=SERVE_WAIT_S)
        async def generate(self, requests):
            import threading

            import torch

            lengths = [len(r) for r in requests]
            ids = torch.zeros(len(requests), max(lengths), dtype=torch.long)
            for i, r in enumerate(requests):
                ids[i, :len(r)] = torch.as_tensor(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                hidden = self.model(ids.cuda(), return_hidden=True)
                last = hidden[torch.arange(len(requests)), torch.as_tensor(lengths) - 1]
                logits = self.model.lm_head(last).float().cpu()
            ms = (time.perf_counter() - t0) * 1e3
            self.batches.append({"lengths": lengths, "ms": ms,
                                 "thread": threading.current_thread().name})
            return [(logits[i].numpy(), int(logits[i].argmax())) for i in range(len(requests))]

        async def __call__(self, ids):
            return await self.generate(ids)

        def reset(self):
            from ray_tpu_torch.ops import attention as A

            A.reset_launch_counts()
            self.batches = []

        def stats(self):
            import os

            import torch

            from ray_tpu_torch.ops import attention as A

            return {"card": torch.cuda.get_device_name(), "launches": dict(A.LAUNCHES),
                    "batches": self.batches,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    return LlamaServer


def phase_serve(card):
    """Serve: a num_gpus=1 llama-1b replica answering two rounds of ragged
    requests through `@serve.batch`; every response held against the same
    request alone through this process's model; K1's launches counted in
    the replica. Returns the replica's K1 launches."""
    import asyncio
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    cfg = replace(CONFIGS[SERVE_MODEL], param_dtype=torch.bfloat16)
    lengths = np.random.RandomState(0).randint(SERVE_MIN_LEN, SERVE_MAX_LEN + 1, SERVE_REQUESTS)
    ids_rng = np.random.RandomState(1)
    requests = [ids_rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]

    async def send_all(handle):
        async def one(r):
            t0 = time.perf_counter()
            out = await handle.remote(r)
            return out, (time.perf_counter() - t0) * 1e3

        return await asyncio.wait_for(asyncio.gather(*(one(r) for r in requests)),
                                      SERVE_TIMEOUT_S)

    serve.start(proxy=False)
    try:
        t0 = time.perf_counter()
        handle = serve.run(llama_server().bind(), name="llama", route_prefix=None,
                           timeout_s=SERVE_TIMEOUT_S)
        ready_s = time.perf_counter() - t0
        handle.reset.remote().result(timeout_s=SERVE_TIMEOUT_S)
        rounds = []
        for _ in range(SERVE_ROUNDS):
            t0 = time.perf_counter()
            answered = asyncio.run(send_all(handle))
            rounds.append({"wall_s": time.perf_counter() - t0, "answers": [a for a, _ in answered],
                           "latency_ms": [ms for _, ms in answered]})
        stats = handle.stats.remote().result(timeout_s=SERVE_TIMEOUT_S)
    finally:
        serve.shutdown()

    check(stats["card"] == torch.cuda.get_device_name(0),
          f"the replica ran on {stats['card']!r}, not on {torch.cuda.get_device_name(0)!r}")
    batches = stats["batches"]
    sizes = [len(b["lengths"]) for b in batches]
    launches = stats["launches"]
    check(sum(sizes) == SERVE_ROUNDS * SERVE_REQUESTS,
          f"the replica's batches {sizes} hold {sum(sizes)} requests, not "
          f"{SERVE_ROUNDS * SERVE_REQUESTS}")
    check(max(sizes) > 1, f"no batch held more than one request: {sizes}")
    check(launches["flash_fwd"] == cfg.num_layers * len(batches),
          f"flash_fwd launched {launches['flash_fwd']} times in the replica for "
          f"{len(batches)} batches, expected {cfg.num_layers * len(batches)}")
    check(launches["flash_bwd_dkv"] == 0 and launches["flash_bwd_dq"] == 0,
          f"backward kernels launched in the replica: {launches}")

    # Each request alone through this process's model, built the same way.
    model = LlamaForCausalLM(cfg, device="cuda")
    worst_rel = 0.0
    with torch.inference_mode():
        for rnd in rounds:
            for r, (got, token) in zip(requests, rnd["answers"]):
                hidden = model(torch.as_tensor([r], device="cuda"), return_hidden=True)
                want = model.lm_head(hidden[:, -1]).float()[0].cpu()
                got = torch.tensor(got)
                diff = (got - want).abs()
                rel = float((got - want).norm() / want.norm())
                worst_rel = max(worst_rel, rel)
                check(bool(torch.isfinite(got).all()) and got.shape == want.shape
                      and rel <= SERVE_LOGITS_REL,
                      f"a served request of {len(r)} tokens: logits relative error {rel:.3e}")
                top2 = want.topk(2).values
                check(token == int(want.argmax()) or float(top2[0] - top2[1]) <= float(diff.max()),
                      f"a served request of {len(r)} tokens: next token {token}, alone "
                      f"{int(want.argmax())} (top-2 gap {float(top2[0] - top2[1]):.3e}, largest "
                      f"difference {float(diff.max()):.3e})")
        # Each batch shape the replica formed, timed in this process.
        here_ms = []
        for b in batches:
            ids = torch.zeros(len(b["lengths"]), max(b["lengths"]), dtype=torch.long, device="cuda")
            model(ids, return_hidden=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVE_FORWARD_REPEATS):
                model(ids, return_hidden=True)
            torch.cuda.synchronize()
            here_ms.append((time.perf_counter() - t0) * 1e3 / SERVE_FORWARD_REPEATS)
    del model
    torch.cuda.empty_cache()

    def pct(xs, q):
        return float(np.percentile(xs, q))

    print(f"Serve {SERVE_MODEL} bf16 on {card}: serve.run to ready {ready_s:.2f} s (GPU worker "
          f"spawn, torch import, CUDA start, weights; replica on "
          f"CUDA_VISIBLE_DEVICES={stats['visible']}, {stats['card']})", flush=True)
    print(f"Serve batches on {card} (max_batch_size {SERVE_MAX_BATCH}, batch_wait_timeout_s "
          f"{SERVE_WAIT_S}): sizes {sizes}, padded T {[max(b['lengths']) for b in batches]}, "
          f"forward ms in the replica {[round(b['ms'], 2) for b in batches]} (first batch "
          f"{batches[0]['ms']:.2f} ms on thread {batches[0]['thread']!r}, the rest median "
          f"{float(np.median([b['ms'] for b in batches[1:]])):.2f} ms), the same batch shapes "
          f"in this process {[round(ms, 2) for ms in here_ms]}", flush=True)
    real_tokens = int(lengths.sum())
    for i, rnd in enumerate(rounds):
        lat = rnd["latency_ms"]
        print(f"Serve round {i} on {card}: {SERVE_REQUESTS} requests of {real_tokens} tokens at "
              f"once, latency through the handle p50 {pct(lat, 50):.1f} ms, p99 "
              f"{pct(lat, 99):.1f} ms, round {rnd['wall_s']:.3f} s, prefill "
              f"{real_tokens / rnd['wall_s']:.0f} tokens/s", flush=True)
    later = batches[1:]
    padded = sum(len(b["lengths"]) * max(b["lengths"]) for b in later)
    print(f"Serve {SERVE_MODEL} on {card}: every response within {SERVE_LOGITS_REL} of the same "
          f"request alone (worst {worst_rel:.3e}), next tokens equal; launches in the replica "
          f"{launches} ({cfg.num_layers} flash_fwd per batch, {len(batches)} batches); prefill "
          f"in the replica's forwards after the first "
          f"{padded / (sum(b['ms'] for b in later) / 1e3):.0f} padded tokens/s: ok", flush=True)
    return launches["flash_fwd"]


def _rl_spaces():
    """CartPole's and Pendulum's spaces as the modules read them, built
    without gymnasium (absent on the card's machine)."""
    from types import SimpleNamespace

    import numpy as np

    cartpole = (SimpleNamespace(shape=(4,)), SimpleNamespace(n=2, shape=()))
    pendulum = (SimpleNamespace(shape=(3,)),
                SimpleNamespace(low=np.full(1, -2.0, np.float32),
                                high=np.full(1, 2.0, np.float32), shape=(1,)))
    return cartpole, pendulum


def _rl_pair(learner_cls, config, spaces):
    """A learner on the card (`num_gpus_per_learner` unset, the default)
    and one on the CPU holding the card learner's start state."""
    spec = config.module_spec(*spaces)
    card = learner_cls(module_spec=spec, config=config.learner_config())
    card.build()
    cpu = learner_cls(module_spec=spec,
                      config=config.copy().learners(num_gpus_per_learner=0).learner_config())
    cpu.build()
    cpu.set_state(card.get_state())
    check(card.device.type == "cuda", f"{learner_cls.__name__} is on {card.device}")
    return card, cpu


def _on(tree, device):
    if tree is None:
        return None
    return {k: v.to(device) for k, v in tree.items()}


def _timed_update(learner, batch, noise=None):
    import numpy as np
    import torch

    t0 = time.perf_counter()
    out = learner.update({k: v.copy() if isinstance(v, np.ndarray) else v
                          for k, v in batch.items()}, noise)
    if learner.device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rl_compare(name, card, cpu, batch, noise=None, warm_batches=(), card_warm_batches=None,
                after_first=None):
    """One update of the card learner and of the CPU learner on the same
    batch and draws: every metric and weight within RL_CARD_ATOL;
    `after_first()` then checks what the update left. Then the first
    update's ms and the warm ones on each (on `warm_batches`, with each
    learner's own draws; the card's on `card_warm_batches` where they are
    given, the same batches already on its device). Returns (line, card
    warm ms)."""
    atol = RL_CARD_ATOL
    want, cpu_first = _timed_update(cpu, batch, noise)
    got, card_first = _timed_update(card, batch, _on(noise, card.device))
    check(all(math.isfinite(v) for v in got.values()), f"{name} card metrics {got}")
    check(sorted(got) == sorted(want), f"{name} metrics {sorted(got)} vs {sorted(want)}")
    metric_err = max(abs(got[k] - want[k]) / max(1.0, abs(want[k])) for k in want)
    got_w, want_w = card.get_weights(), cpu.get_weights()
    weight_err = max(float((got_w[k] - want_w[k]).abs().max()) for k in want_w)
    check(metric_err <= atol and weight_err <= atol,
          f"{name}: card learner differs from the CPU learner by {metric_err:.2e} (metrics), "
          f"{weight_err:.2e} (weights); atol {atol}")
    extra = after_first() if after_first else ""
    card_warm, cpu_warm = [], []
    for b, card_b in zip(warm_batches, card_warm_batches or warm_batches):
        card_warm.append(_timed_update(card, card_b)[1])
        cpu_warm.append(_timed_update(cpu, b)[1])
    line = (f"{name}: card vs CPU learner from one start state on one batch: largest metric "
            f"difference {metric_err:.2e} (relative past 1), weight {weight_err:.2e} (atol {atol}); "
            f"ms per update on the card {card_first:.2f} (then "
            f"{', '.join(f'{x:.2f}' for x in card_warm)}), on the CPU {cpu_first:.2f} (then "
            f"{', '.join(f'{x:.2f}' for x in cpu_warm)}){extra}")
    return line, card_warm


def _replay_batches(replay, learner, n, size, extra=None):
    """`n` replay samples of `size` (with the entries of `extra` added),
    each timed from the draw to its one copy on the learner's device (the
    host's share of a replay update, as DQN's and SAC's training steps
    pay it). Returns the host batches, the device batches the card's
    warm updates take, and the ms."""
    import torch

    batches, on_device, ms = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        b = replay.sample(size)
        b.pop("batch_indexes")
        b.update(extra or {})
        on_device.append(learner.device_batch(b))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        batches.append(b)
    return batches, on_device, ms


def phase_rllib(card):
    """The rest of RLlib with its learners on the card: DQN (PER), IMPALA,
    APPO, SAC, CQL, MARWIL, BC and DreamerV3 each against a CPU learner,
    offline data through the port's Data, two PPO policies through
    MultiAgentLearnerGroup, and (where gymnasium is installed) the tuned
    examples' DQN and SAC runs."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib.algorithms import appo, cql, dqn, impala, marwil, sac
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import (
        DreamerV3Config, DreamerV3Learner, _EpisodeReplay)
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _group_of as dreamer_group_of
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
    from ray_tpu_torch.rllib.core.multi_agent_learner_group import MultiAgentLearnerGroup
    from ray_tpu_torch.rllib.core.multi_rl_module import MultiRLModuleSpec
    from ray_tpu_torch.rllib.offline import OfflineData, SampleWriter
    from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer

    cartpole, pendulum = _rl_spaces()
    rng = np.random.RandomState(0)
    lines = []

    # ---- DQN with prioritized replay: QNetworkModule at its defaults.
    cfg = dqn.DQNConfig().training(prioritized_replay=True, target_network_update_freq=32,
                                   lr=1e-3).debugging(seed=0)
    card_l, cpu_l = _rl_pair(dqn.DQNLearner, cfg, cartpole)
    replay = PrioritizedReplayBuffer(10_000, alpha=cfg.per_alpha, beta=cfg.per_beta, seed=0)
    replay.add_episodes(cartpole_episodes(5000, seed=1))
    batch = replay.sample(cfg.train_batch_size)
    idx = batch.pop("batch_indexes")
    td_err = float(np.abs(card_l.td_errors(batch) - cpu_l.td_errors(batch)).max())
    check(td_err <= RL_CARD_ATOL, f"DQN TD errors differ by {td_err:.2e}")
    warm, card_warm, host_ms = _replay_batches(replay, card_l, RL_WARM_UPDATES,
                                               cfg.train_batch_size)

    def dqn_target():
        target = card_l.target_params["q"].layers[0].weight
        check(target.device.type == "cuda", f"the DQN target is on {target.device}")
        check(all(torch.equal(card_l.target_params.state_dict()[k], v)
                  for k, v in card_l.params.state_dict().items()),
              "the DQN target did not sync (target_updates_every 1)")
        return f"; the target synced on {target.device}"

    line, card_ms = _rl_compare("DQN (PER, double-Q)", card_l, cpu_l, batch, warm_batches=warm,
                                card_warm_batches=card_warm, after_first=dqn_target)
    replay.update_priorities(idx, card_l.td_errors(batch))
    lines.append(f"{line}; TD errors within {td_err:.2e}; host sample-and-copy ms per update "
                 f"{', '.join(f'{x:.2f}' for x in host_ms)} against the update's "
                 f"on the copied batch {', '.join(f'{x:.2f}' for x in card_ms)}")

    # ---- IMPALA and APPO at the PPO module's widths.
    for mod, cls, extra in ((impala, "IMPALA", {}), (appo, "APPO", {"use_kl_loss": True})):
        cfg = getattr(mod, f"{cls}Config")().training(**extra).debugging(seed=0)
        card_l, cpu_l = _rl_pair(getattr(mod, f"{cls}Learner"), cfg, cartpole)
        batches = [cpu_l.build_batch(cartpole_episodes(cfg.train_batch_size, seed=s))
                   for s in range(2, 2 + 1 + RL_WARM_UPDATES)]
        line, _ = _rl_compare(cls, card_l, cpu_l, batches[0], warm_batches=batches[1:])
        if cls == "APPO":
            t = card_l.target_params["pi"].layers[0].weight
            check(t.device.type == "cuda", f"the APPO target is on {t.device}")
            line += f"; the target policy on {t.device}"
        shape = batches[0]["obs"].shape
        lines.append(f"{line}; batch {shape[0]} x {shape[1]} steps")

    # ---- SAC and CQL at (256, 256), Pendulum's shapes; draws made once on
    # the CPU and given to both learners.
    data = ReplayBuffer(100_000, seed=0)
    n = 20_000
    data.add_batch({
        "obs": rng.randn(n, 3).astype(np.float32), "next_obs": rng.randn(n, 3).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        "rewards": -rng.rand(n).astype(np.float32) * 16,
        "terminateds": np.zeros(n, np.float32)})
    for mod, cls in ((sac, "SAC"), (cql, "CQL")):
        cfg = getattr(mod, f"{cls}Config")().debugging(seed=0)
        card_l, cpu_l = _rl_pair(getattr(mod, f"{cls}Learner"), cfg, pendulum)
        batch = data.sample(cfg.train_batch_size)
        batch.pop("batch_indexes")
        if cls == "CQL":
            batch["bc_phase"] = np.float32(1.0)
        noise = cpu_l.draw_noise(cpu_l.device_batch(batch))
        before = {k: v.clone() for k, v in card_l.target_q.state_dict().items()}
        warm, card_warm, host_ms = _replay_batches(
            data, card_l, RL_WARM_UPDATES, cfg.train_batch_size,
            extra={"bc_phase": np.float32(0.0)} if cls == "CQL" else None)

        def polyak(card_l=card_l, before=before, tau=cfg.tau, cls=cls):
            after, online = card_l.target_q.state_dict(), card_l.params.state_dict()
            err = max(float((after[k] - ((1 - tau) * before[k] + tau * online[k])).abs().max())
                      for k in after)
            t = card_l.target_q["q1"].layers[0].weight
            check(t.device.type == "cuda" and err <= 1e-6,
                  f"the {cls} target pair is on {t.device}, off its polyak step by {err:.2e}")
            return f"; the polyak step on {t.device} within {err:.2e}"

        line, card_ms = _rl_compare(cls, card_l, cpu_l, batch, noise, warm_batches=warm,
                                    card_warm_batches=card_warm, after_first=polyak)
        lines.append(f"{line}; widths {card_l.module._hidden}, batch {cfg.train_batch_size}; "
                     f"host sample-and-copy ms per update "
                     f"{', '.join(f'{x:.2f}' for x in host_ms)} against the update's on the "
                     f"copied batch {', '.join(f'{x:.2f}' for x in card_ms)}")

    # ---- Offline: episodes through SampleWriter and the port's Data,
    # then MARWIL and BC from them.
    episodes = cartpole_episodes(RL_OFFLINE_STEPS, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        writer = SampleWriter(tmp)
        writer.write(episodes)
        writer.close()
        t0 = time.perf_counter()
        read = [ep for b in OfflineData(tmp).iter_episode_batches(batch_size=2000) for ep in b]
        read_s = time.perf_counter() - t0
    check(len(read) == len(episodes), f"offline: {len(read)} episodes of {len(episodes)}")
    for a, b in zip(episodes, read):
        same = (np.array_equal(np.asarray(a.observations), np.asarray(b.observations))
                and np.array_equal(np.asarray(a.actions), np.asarray(b.actions))
                and np.array_equal(np.asarray(a.rewards), np.asarray(b.rewards))
                and (a.is_terminated, a.is_truncated) == (b.is_terminated, b.is_truncated)
                and np.array_equal(np.asarray(a.extra_model_outputs["action_logp"]),
                                   np.asarray(b.extra_model_outputs["action_logp"])))
        check(same, "an episode did not round-trip through SampleWriter and OfflineData")
    lines.append(f"offline: {len(episodes)} CartPole-shaped episodes ({RL_OFFLINE_STEPS} steps) "
                 f"through SampleWriter and OfflineData on the port's Data in {read_s:.2f} s, "
                 f"every one exactly")
    chunks, batch_eps, steps = [], [], 0
    for ep in read:
        batch_eps.append(ep)
        steps += len(ep)
        if steps >= 2000:
            chunks.append(batch_eps)
            batch_eps, steps = [], 0
    for cls, extra in (("BC", {"minibatch_size": 128, "num_epochs": 5}), ("MARWIL", {})):
        cfg = getattr(marwil, f"{cls}Config")().training(**extra).debugging(seed=0)
        card_l, cpu_l = _rl_pair(marwil.MARWILLearner, cfg, cartpole)
        batches = [cpu_l.build_batch(c) for c in chunks[: 1 + RL_WARM_UPDATES]]
        line, _ = _rl_compare(cls, card_l, cpu_l, batches[0], warm_batches=batches[1:])
        lines.append(f"{line}; from the offline episodes, {len(batches[0]['obs'])} steps an "
                     f"update")

    # ---- Multi-agent: two PPO policies, local learners on the card.
    cfg = PPOConfig().training(minibatch_size=128, num_epochs=2).debugging(seed=0)
    base = cfg.module_spec(*cartpole)
    spec = MultiRLModuleSpec({"p0": base, "p1": cfg.module_spec(*cartpole)})
    group = MultiAgentLearnerGroup(learner_cls=PPOLearner, module_spec=spec,
                                   config=cfg.learner_config())
    eps = cartpole_episodes(4000, seed=9)
    for i, ep in enumerate(eps):
        ep.module_id = f"p{i % 2}"
    start = group.get_weights()
    t0 = time.perf_counter()
    got = group.update_from_episodes(eps)
    group_ms = (time.perf_counter() - t0) * 1e3
    after = group.get_weights()
    for mid in ("p0", "p1"):
        local = group._groups[mid]._local
        check(local.device.type == "cuda", f"policy {mid}'s learner is on {local.device}")
        single = LearnerGroup(learner_cls=PPOLearner, module_spec=spec.module_specs[mid],
                              config=cfg.learner_config())
        single.set_weights(start[mid])
        want = single.update_from_episodes([ep for ep in eps if ep.module_id == mid])
        err = max(abs(got[f"{mid}/{k}"] - v) for k, v in want.items())
        w = single.get_weights()
        werr = max(float((after[mid][k] - w[k]).abs().max()) for k in w)
        check(err <= RL_CARD_ATOL and werr <= RL_CARD_ATOL,
              f"policy {mid} differs from a single-agent learner on its episodes by {err:.2e} "
              f"(metrics), {werr:.2e} (weights)")
    lines.append(f"multi-agent: two PPO policies through MultiAgentLearnerGroup, local learners "
                 f"on the card, {len(eps)} episodes routed by module: each policy's metrics and "
                 f"weights equal a single-agent learner's on its episodes (atol {RL_CARD_ATOL}); "
                 f"{group_ms:.1f} ms for both updates")
    group.shutdown()

    # ---- DreamerV3 at its DreamerV3Config defaults; a TF32 control.
    cfg = DreamerV3Config().debugging(seed=0)
    card_l = DreamerV3Learner(4, 2, cfg)
    check(card_l.device.type == "cuda", f"the DreamerV3 learner is on {card_l.device}")
    cpu_cfg = cfg.copy().learners(num_gpus_per_learner=0)
    state = card_l.get_state()
    replay = _EpisodeReplay(cfg.replay_capacity_steps, seed=0)
    for ep in cartpole_episodes(4000, seed=11):
        replay.add(ep.observations, ep.actions, ep.rewards, ep.is_terminated)
    B, T = cfg.batch_size_B, cfg.batch_length_T
    batches = [replay.sample(B, T) for _ in range(1 + RL_WARM_UPDATES)]

    def dreamer_step(device_cfg, tf32=False):
        learner = DreamerV3Learner(4, 2, device_cfg)
        learner.set_state(state)
        noise = _on(dreamer_noise, learner.device)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            m = learner.train_step(batches[0], noise)
            m = {k: float(v) for k, v in m.items()}
            first = (time.perf_counter() - t0) * 1e3
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return learner, m, first

    dreamer_noise = DreamerV3Learner(4, 2, cpu_cfg).draw_noise(B, T)
    cpu_dv, want, cpu_first = dreamer_step(cpu_cfg)
    card_dv, got, card_first = dreamer_step(cfg)
    tf32_dv, tf32_m, _ = dreamer_step(cfg, tf32=True)
    step = {"wm": cfg.lr, "actor": cfg.actor_lr, "critic": cfg.critic_lr,
            "slow_critic": (1 - cfg.critic_ema_decay) * cfg.critic_lr}
    weight_limits = {g: DREAMER_STEP_SHARE * v for g, v in step.items()}

    def group_weights(learner):
        state = learner.get_state()
        out = {g: {} for g in step}
        for k, v in state["params"].items():
            out[dreamer_group_of(k)][k] = v
        out["slow_critic"] = state["slow_critic"]
        return out

    want_w = group_weights(cpu_dv)

    def errs(m, learner):
        w = group_weights(learner)
        return (max(abs(m[k] - want[k]) / max(1.0, abs(want[k])) for k in want),
                {g: max(float((w[g][k] - want_w[g][k]).abs().max()) for k in want_w[g])
                 for g in step})

    metric_err, weight_err = errs(got, card_dv)
    tf32_metric_err, tf32_weight_err = errs(tf32_m, tf32_dv)
    weight_line = ", ".join(
        f"{g} {weight_err[g]:.2e} (limit {weight_limits[g]:.1e}; TF32 {tf32_weight_err[g]:.2e})"
        for g in step)
    check(all(math.isfinite(v) for v in got.values()), f"DreamerV3 card metrics {got}")
    check(metric_err <= DREAMER_CARD_RTOL
          and all(weight_err[g] <= weight_limits[g] for g in step),
          f"DreamerV3: card vs CPU {metric_err:.2e} (metrics, limit {DREAMER_CARD_RTOL}); "
          f"weights {weight_line}")
    check(tf32_metric_err > DREAMER_CARD_RTOL
          and all(tf32_weight_err[g] > weight_limits[g] for g in step),
          f"DreamerV3: the TF32 control ({tf32_metric_err:.2e}; weights {weight_line}) is "
          f"within a float32 limit, which then tells the two apart no better than TF32")
    slow = card_dv.slow_critic.out.weight
    check(slow.device.type == "cuda", f"the slow critic is on {slow.device}")
    card_warm, cpu_warm = [], []
    for b in batches[1:]:
        for learner, out in ((card_dv, card_warm), (cpu_dv, cpu_warm)):
            t0 = time.perf_counter()
            m = learner.train_step(b)
            float(m["wm_loss"])
            out.append((time.perf_counter() - t0) * 1e3)
    mc = cfg.model_config
    lines.append(
        f"DreamerV3 (deter {mc['deter']}, {mc['stoch_groups']} x {mc['stoch_classes']} "
        f"stochastic, units {mc['units']}, B {B}, T {T}, horizon {cfg.horizon}): one train step "
        f"(world model and actor-critic) of the card learner against the CPU learner's from one "
        f"state on one batch with the same Gumbel draws: wm_loss {got['wm_loss']:.6f} against "
        f"{want['wm_loss']:.6f}, largest metric difference {metric_err:.2e} (relative past 1; "
        f"limit {DREAMER_CARD_RTOL}; the TF32 control {tf32_metric_err:.2e}), weights by "
        f"group {weight_line}; ms "
        f"per train step on the card "
        f"{card_first:.1f} (then {', '.join(f'{x:.1f}' for x in card_warm)}), on the CPU "
        f"{cpu_first:.1f} (then {', '.join(f'{x:.1f}' for x in cpu_warm)})")
    for line in lines:
        print(f"{line}; {card}: ok", flush=True)

    # ---- The tuned examples' learning runs, where there is an env.
    try:
        import gymnasium  # noqa: F401
        import yaml  # noqa: F401
    except ImportError:
        print("RLlib tuned examples (cartpole_dqn.yaml, pendulum_sac.yaml): not run, "
              "gymnasium or yaml is not installed on this machine (the learners were held on "
              "batches built without an env)", flush=True)
        return
    from ray_tpu_torch.rllib import tuned_examples as tx

    # The reference's own run of cartpole_dqn.yaml stays below its bar
    # of 80 on the CPU: its best is printed, and only its finiteness held.
    for name, held in (("pendulum_sac.yaml", True), ("cartpole_dqn.yaml", False)):
        t0 = time.perf_counter()
        res = tx.run_regression(os.path.join(tx.EXAMPLES_DIR, name))
        check(all(math.isfinite(v) for v in res.best.values()), f"{name}: best {res.best}")
        if held:
            check(res.passed, f"{name} failed: best {res.best} in {res.iterations} iterations")
        print(f"RLlib tuned example {name} with its learner on the card: best {res.best} in "
              f"{res.iterations} iterations ({'passed' if res.passed else 'below its bar'}), "
              f"{time.perf_counter() - t0:.1f} s; {card}: ok", flush=True)


def job_train_task():
    """Phase 25's task, in a num_gpus=1 worker of the node the autoscaler
    added: phase 18's method (phase 5's llama-1b, seed and batches through
    `bench_model`), with K1-K3 counted in this process."""
    import os
    import time
    from dataclasses import replace

    import torch

    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    A.reset_launch_counts()
    first_step = time.time()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    return {"losses": r["losses"], "step_ms": r["step_ms"], "launches": dict(A.LAUNCHES),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "card": torch.cuda.get_device_name(), "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID"),
            "first_step": first_step}


def job_driver() -> int:
    """`chip_smoke.py --job-driver`, phase 25's job entrypoint: a driver of
    the standalone head (`init(address="auto")`) that runs `job_train_task`
    as one `num_gpus=1` task and prints its result. It runs on the head's
    node, in a process that imports no torch and touches no card."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    try:
        task = rt.remote(num_gpus=1)(job_train_task)
        out = rt.get(task.remote(), timeout=JOB_TIMEOUT_S)
    finally:
        rt.shutdown()
    print(JOB_RESULT_TAG + json.dumps(out), flush=True)
    return 0


def _port_processes():
    """Pids of this machine's processes of the port's runtime: heads
    (`python -m ray_tpu_torch start`), node daemons, zygotes and workers."""
    out = set()
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
        except OSError:
            continue
        if b"ray_tpu_torch" in cmd and int(pid) != os.getpid():
            out.add(int(pid))
    return out


def _port_pools():
    return {p for p in os.listdir("/dev/shm") if p.startswith("rtpt_")}


def phase_job(card, in_process):
    """Phase 25: a standalone head with no GPU, the v2 reconciler adding a
    GPU host for a job's num_gpus=1 task, the job run through the CLI and
    watched through the state API, the CLI and the dashboard, then the
    host scaled down and everything stopped. Returns the task's launches."""
    import shutil
    import socket
    import subprocess
    import threading
    import urllib.request

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.gpu_hosts import GpuHostProvider, HostGroupType, MockGpuHostApi
    from ray_tpu_torch.autoscaler.v2 import RAY_RUNNING, TERMINATED, Reconciler
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.util.state import list_nodes

    repo = os.path.dirname(os.path.abspath(__file__))
    procs_before, pools_before = _port_processes(), _port_pools()
    # A temp root of the phase's own: the head's session file, logs and
    # sockets lie under it, and no other head on the machine is read.
    root = tempfile.mkdtemp(prefix="rtpt")
    saved_root = os.environ.get("RAY_TPU_TORCH_TEMP_DIR")
    os.environ["RAY_TPU_TORCH_TEMP_DIR"] = root
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}

    def cli(*args, timeout=120):
        return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], env=env, cwd=repo,
                              capture_output=True, text=True, timeout=timeout)

    head_log = open(os.path.join(root, "head.out"), "w")
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--num-cpus", "2",
         "--num-gpus", "0", "--port", "0"],
        env=env, cwd=repo, stdout=head_log, stderr=subprocess.STDOUT)
    api = MockGpuHostApi(log_dir=root)
    stop = threading.Event()
    loop_errors, events = [], {}
    thread = None
    try:
        # 1. the head, up once `status` answers
        t0 = time.perf_counter()
        while True:
            status = cli("status")
            if status.returncode == 0 and "Cluster status" in status.stdout:
                break
            if head.poll() is not None:
                with open(head_log.name) as f:
                    check(False, f"the head exited: {f.read()[-4000:]}")
            check(time.perf_counter() - t0 < 60, f"status never answered: {status.stderr[-2000:]}")
            time.sleep(0.5)
        head_up_s = time.perf_counter() - t0
        rt.init(address="auto")
        head_res = rt.cluster_resources()
        check(head_res == {"CPU": 2.0}, f"the head holds {head_res}, not 2 CPUs and no GPU")

        # 2. the reconciler, over one host of one GPU: this machine's card
        provider = GpuHostProvider(
            api, {"h100": HostGroupType(hosts=1, host_resources={"CPU": 4.0, "GPU": 1.0})})
        rec = Reconciler(provider.node_types(), provider, idle_timeout_s=JOB_IDLE_TIMEOUT_S)

        def reconcile():
            while not stop.is_set():
                try:
                    rec.step()
                except Exception as e:  # noqa: BLE001 - checked below, never swallowed
                    loop_errors.append(repr(e))
                    return
                if rec.im.instances(RAY_RUNNING):
                    events.setdefault("running", time.perf_counter())
                if rec.im.instances(TERMINATED):
                    events.setdefault("terminated", time.perf_counter())
                stop.wait(0.25)

        rec.step()  # the autoscaler announces itself before the demand
        thread = threading.Thread(target=reconcile, name="phase25-reconciler", daemon=True)
        thread.start()
        dashboard = None
        try:
            import aiohttp  # noqa: F401
        except ImportError:
            print("aiohttp is not installed: phase 25 runs without the dashboard", flush=True)
        else:
            from ray_tpu_torch.dashboard import start_dashboard

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dash_port = s.getsockname()[1]
            dashboard = start_dashboard(port=dash_port)

        def dash_get(path):
            with urllib.request.urlopen(f"{dashboard}{path}", timeout=30) as r:
                return json.loads(r.read())

        # 3. the job, through the CLI, with the repo on its PYTHONPATH
        submit_wall, t_submit = time.time(), time.perf_counter()
        sub = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "submit", "--wait", "--runtime-env-json",
             json.dumps({"env_vars": {"PYTHONPATH": repo}}), "--",
             "python3", os.path.join(repo, "chip_smoke.py"), "--job-driver"],
            env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        first = sub.stdout.readline()
        check(first.startswith("submitted "), f"submit said {first!r}")
        job_id = first.split()[1].rstrip(":")
        while "running" not in events:
            check(not loop_errors, f"the reconciler failed: {loop_errors}")
            if sub.poll() is not None:
                check(False, f"the job ended before a GPU node joined: {sub.stdout.read()[-4000:]}")
            check(time.perf_counter() - t_submit < JOB_TIMEOUT_S, "no GPU node joined")
            time.sleep(0.1)
        node_s = events["running"] - t_submit
        inst, = rec.im.instances(RAY_RUNNING)
        label = f"v2:{inst.instance_id}:h0"

        # 4. while the job runs: the node through the state API, the CLI
        # and the dashboard
        node, = [n for n in list_nodes() if n["label"] == label]
        check(node["alive"] and node["total"].get("GPU") == 1.0,
              f"the state API lists the GPU node as {node}")
        listed = cli("list", "nodes")
        row = [line for line in listed.stdout.splitlines() if label in line]
        check(listed.returncode == 0 and len(row) == 1 and "True" in row[0]
              and "'GPU': 1.0" in row[0], f"`list nodes` printed {listed.stdout!r}")
        if dashboard is not None:
            dash_nodes = [n for n in dash_get("/api/nodes") if n["label"] == label]
            check(len(dash_nodes) == 1 and dash_nodes[0]["alive"]
                  and dash_nodes[0]["total"].get("GPU") == 1.0,
                  f"the dashboard's /api/nodes shows {dash_nodes}")
            dash_jobs = [j for j in dash_get("/api/jobs") if j["job_id"] == job_id]
            check(len(dash_jobs) == 1, f"the dashboard's /api/jobs lacks {job_id}")
        jobs = JobSubmissionClient()
        running = jobs.get_job_status(job_id).value
        check(running == "RUNNING", f"the job was {running} when the node was read, not RUNNING")

        out, _ = sub.communicate(timeout=JOB_TIMEOUT_S)
        t_end = time.perf_counter()
        end_s = t_end - t_submit
        check(sub.returncode == 0, f"`submit --wait` exited {sub.returncode}: {out[-4000:]}")
        final = jobs.get_job_status(job_id).value
        check(final == "SUCCEEDED", f"the job ended {final}")
        lines = [line for line in jobs.get_job_logs(job_id).splitlines()
                 if line.startswith(JOB_RESULT_TAG)]
        check(len(lines) == 1, f"the job printed {len(lines)} result lines: {out[-4000:]}")
        r = json.loads(lines[0][len(JOB_RESULT_TAG):])

        # 5. what the task saw and did
        check(r["node_id"] == inst.node_id.hex(),
              f"the task ran on node {r['node_id']}, not the autoscaled {inst.node_id.hex()}: "
              f"nodes {[(n['node_id'], n['label'], n['alive'], n.get('death_reason')) for n in list_nodes()]}")
        check(r["visible"] == "0", f"the task's worker sees CUDA_VISIBLE_DEVICES={r['visible']!r}")
        check(r["card"] == torch.cuda.get_device_name(0), f"the task's card is {r['card']}")
        steps = TIMED_STEPS + 1
        layers = CONFIGS["llama-1b"].num_layers
        per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"job: {name} launched {r['launches'][name]} times in {steps} steps, "
                  f"expected {k * steps}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], in_process["losses"])]
        check(len(rel) == steps and max(rel) <= TRAINER_LOSS_RTOL,
              f"job losses {r['losses']} vs in-process {in_process['losses']}: relative {rel}")
        summary = cli("summary", "tasks")
        check(summary.returncode == 0, f"`summary tasks` failed: {summary.stderr[-2000:]}")
        counted = json.loads(summary.stdout)["by_func_name"].get("job_train_task", {})
        check(counted == {"FINISHED": 1}, f"`summary tasks` counts job_train_task as {counted}")

        # 6. scale-down after the job
        while "terminated" not in events:
            check(not loop_errors, f"the reconciler failed: {loop_errors}")
            check(time.perf_counter() - t_end < JOB_IDLE_TIMEOUT_S + JOB_SCALE_DOWN_SLACK_S,
                  f"the GPU node was not scaled down within {JOB_IDLE_TIMEOUT_S} + "
                  f"{JOB_SCALE_DOWN_SLACK_S} s of the job's end: {rec.summary()}")
            time.sleep(0.1)
        down_s = events["terminated"] - t_end
        dead = [n for n in list_nodes() if n["label"] == label]
        check(len(dead) == 1 and not dead[0]["alive"], f"after scale-down the node reads {dead}")
        check(api.list_groups() == {}, f"hosts left after scale-down: {api.list_groups()}")
    except BaseException:
        # The consoles of the head and of every host, for the failure
        # being raised.
        for log in sorted(os.listdir(root)):
            if log.endswith((".out", ".log")):
                with open(os.path.join(root, log), errors="replace") as f:
                    print(f"--- {log}:\n{f.read()[-3000:]}", file=sys.stderr, flush=True)
        raise
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=30)
        rt.shutdown()
        api.shutdown()
        # 7. stop: the head exits and takes its workers with it
        stopped = cli("stop", timeout=60)
        try:
            head.wait(timeout=60)
        except subprocess.TimeoutExpired:
            head.kill()
            head.wait(timeout=30)
            raise RuntimeError(f"the head did not exit after `stop`: {stopped.stdout}")
        head_log.close()
        if saved_root is None:
            os.environ.pop("RAY_TPU_TORCH_TEMP_DIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TEMP_DIR"] = saved_root
    left, deadline = None, time.perf_counter() + 30
    while time.perf_counter() < deadline:
        left = (_port_processes() - procs_before, _port_pools() - pools_before)
        if left == (set(), set()):
            break
        time.sleep(0.5)
    check(left == (set(), set()), f"left after `stop`: processes {left[0]}, pools {left[1]}")
    shutil.rmtree(root, ignore_errors=True)
    first_step_s = r["first_step"] - submit_wall
    print(f"job on an autoscaled GPU node ({card}): head up in {head_up_s:.1f} s with "
          f"{head_res} (no GPU); submit to the GPU node's registration {node_s:.1f} s, to the "
          f"task's first step {first_step_s:.1f} s, to the job's end {end_s:.1f} s", flush=True)
    print(f"job: task on node {label} (not the head), CUDA_VISIBLE_DEVICES={r['visible']}, "
          f"{r['card']}; llama-1b b{BATCH} s{SEQ} bf16 losses {[round(x, 4) for x in r['losses']]} "
          f"against in-process {[round(x, 4) for x in in_process['losses']]} (largest relative "
          f"difference {max(rel):.2e}, rtol {TRAINER_LOSS_RTOL}); step {r['step_ms']:.1f} ms in "
          f"the job's task against {in_process['step_ms']:.1f} ms in process; launches "
          f"{r['launches']} ({per_step} per step)", flush=True)
    print(f"job: the node alive with GPU 1 in list_nodes() and `list nodes` while the job ran; "
          f"dashboard {'ran: /api/nodes and /api/jobs showed the node and the job' if dashboard else 'did not run (no aiohttp)'}; "
          f"`summary tasks` job_train_task {counted}; scaled down {down_s:.1f} s after the job's "
          f"end (idle timeout {JOB_IDLE_TIMEOUT_S} s), the node dead; after `stop` no port "
          f"process or rtpt_ pool left: ok", flush=True)
    return {name: r["launches"][name] for name in per_step}


def main() -> int:
    if sys.argv[1:] == ["--job-driver"]:
        return job_driver()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ray_tpu_torch._device import card_description
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import (
        CONFIGS, LlamaForCausalLM, causal_lm_loss, chunked_causal_lm_loss,
    )
    from ray_tpu_torch.models import mixtral as M
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import gmm as G

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_description()
    check(card is not None, "nvidia-smi did not report the card")
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    report_build(_build)
    try:
        import gymnasium

        print(f"gymnasium {gymnasium.__version__} (phase 22's CartPole)", flush=True)
    except ImportError:
        print("gymnasium is not installed: phase 22 holds the learner on batches built "
              "without an env", flush=True)

    # 3. attention kernels
    numbers = phase_kernels(A)
    # 4. grouped-matmul kernels
    numbers.update(phase_gmm(G))
    torch.cuda.empty_cache()

    # 5. Llama train: the Llama path, counted from zero
    from dataclasses import replace

    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    A.reset_launch_counts()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    launches = dict(A.LAUNCHES)
    llama_in_process = r
    losses = r["losses"]
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    steps = TIMED_STEPS + 1
    # remat "nothing": K1 runs in each layer's forward and again in its
    # recompute; K2 and K3 once per layer in backward.
    per_step = {"flash_fwd": 2 * cfg.num_layers, "flash_bwd_dkv": cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers}
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{name} launched {launches[name]} times in {steps} steps, "
              f"expected {n * steps}")
    print(f"train llama-1b b{BATCH} s{SEQ} bf16 on {card}: losses "
          f"{[round(x, 4) for x in losses]}, {r['tokens_per_s']:.1f} tokens/s, "
          f"step {r['step_ms']:.1f} ms, MFU {r['mfu']:.4f} of "
          f"{H100_BF16_PEAK_FLOPS:.3g} FLOP/s; launches {launches}", flush=True)

    # 6. chunked loss
    import numpy as np

    ids = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab_size, (BATCH, SEQ)),
                          dtype=torch.long, device="cuda")
    targets = torch.roll(ids, -1, dims=1)
    with torch.no_grad():
        full = float(causal_lm_loss(model(ids), targets))
        chunked = float(chunked_causal_lm_loss(model, ids, targets, chunk_size=1024))
    rel = abs(chunked - full) / abs(full)
    check(math.isfinite(full) and rel < CHUNKED_LOSS_RTOL,
          f"chunked loss {chunked} vs full {full} (rel {rel:.2e})")
    print(f"chunked loss: {chunked:.6f} vs full {full:.6f} (rel {rel:.2e}): ok",
          flush=True)
    del model
    torch.cuda.empty_cache()

    # 7. MoE dispatch: gmm against the ragged oracle
    phase_moe_dispatch(M, card)
    torch.cuda.empty_cache()

    # 8. Mixtral train: the Mixtral path, counted from zero
    moe_launches = phase_mixtral(A, G, M, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()

    # 9. dispatch probe
    phase_probe(M)
    torch.cuda.empty_cache()

    # 10. attention kernels at the long-context and GPT shapes
    phase_long_kernels(A)
    # 11. GPT: parity on a small input, then the gpt2-large path counted from zero
    phase_gpt(A, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    # 12. the long-context sweep, counted from zero
    phase_longctx(A, card, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    # 13. ring blocks in one process
    phase_ring_blocks(A)
    # 14. the ring over RING_RANKS processes on the card, counted in each rank
    phase_ring(A, card)
    torch.cuda.empty_cache()
    # 15. the pipeline over PIPE_STAGES processes, counted in each rank
    phase_pipeline(A, card)
    torch.cuda.empty_cache()
    # 16. expert parallelism over data x expert processes, counted in each rank
    phase_expert(A, card)
    torch.cuda.empty_cache()
    # 17. the runtime: the card detected, tensors through the object store
    phase_object_plane(card)
    # 18. TorchTrainer at llama-1b in a GPU worker, counted in the worker
    trainer_step_ms = phase_trainer(A, card, llama_in_process)
    import ray_tpu_torch as rt

    rt.init()
    try:
        # 19. Data -> TorchTrainer -> llama-1b, counted in the worker
        phase_data_trainer(card, llama_in_process, trainer_step_ms)
        # 20. collectives with CUDA tensors between two actors on the card
        phase_collectives(card)
        # 21. Tune: two trials of llama-1b queued on the card, counted in each worker
        phase_tune(card, llama_in_process)
        # 22. RLlib PPO with its learner on the card
        phase_ppo(card)
        # 23. Serve: a num_gpus=1 llama-1b replica, K1 counted in the replica
        serve_launches = phase_serve(card)
        # 24. the rest of RLlib: every other learner on the card, offline
        # data, multi-agent, DreamerV3
        phase_rllib(card)
    finally:
        rt.shutdown()
    # 25. a job on an autoscaled GPU node, K1-K3 counted in its task
    job_launches = phase_job(card, llama_in_process)

    # Each kernel's launches on its own path: K1-K3 on the Llama path, K4
    # and K5 on the Mixtral path.
    launches.update({name: moe_launches[name] for name in ("gmm", "tgmm")})
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        n = numbers[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": n["max_abs_err"],
            "ms": n["ms"], "plain_ms": n["plain_ms"], "bound_ms": n["bound"][0],
            "bound_by": n["bound"][1], "library_ms": n["library_ms"],
        })
        if name == "flash_fwd":
            kernels[-1]["serve_launches"] = serve_launches
        if name in job_launches:
            kernels[-1]["job_launches"] = job_launches[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
