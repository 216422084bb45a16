#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one CUDA card,
and on four where the host has them (phase 30).

    python3 chip_smoke.py               # phases 1-30
    python3 chip_smoke.py --phase 30    # phases 1-2, 5 and 30 alone
    python3 chip_smoke.py --phase 30c-bf16  # phases 1-2, then the bf16
                                            # tensor split (a measurement)

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
   parameters, chunked loss, one step then RING_TIMED_STEPS timed; full
   width, depth cut to RING_LAYERS of the 22 layers): every loss
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
   ran;
26. the rest of the surface, on a runtime of the phase's own
   (`init(client_server_port=0)` under a temp root of its own), each
   part held against SERVE_MODEL built once in this process (seed 0,
   bf16) or phase 5's losses: (a) a compiled DAG of a `num_gpus=1`
   stage holding the model, whose method returns a request's
   last-position logits as the card's tensor, and a CPU stage taking
   the argmax; SURFACE_REQUESTS requests drawn as phase 23's through
   `execute`, through `submit`/`collect` with the pipe full, and through
   `.remote()` calls on the same actors; every row within
   SERVE_LOGITS_REL, the same next token, K1 once per layer per request
   in stage 1 and no K2 or K3, the logits reaching stage 2 as host
   float32 tensors, and none of the DAG's `rtpt_` segments and
   semaphores left after `teardown()`; (b) a workflow of `make_batches`
   (phase 5's ids), a `num_gpus=1` step taking phase 5's steps and
   `summarize`, which fails once: `resume` runs it alone (counter files),
   the losses within TRAINER_LOSS_RTOL of phase 5's, K1-K3 2L/L/L a step
   in the step's worker; where aiohttp is installed, a `wait_for_event`
   step released by a POST to the dashboard's
   `/api/workflow/events/{key}`; (c) a thin client, `chip_smoke.py
   --client-driver` in a process with CUDA_VISIBLE_DEVICES empty and only
   the `ray_tpu_torch://` address, runs one `num_gpus=1` task and one
   `num_gpus=1` actor forward of a request: host tensors within
   SERVE_LOGITS_REL, K1 once per layer in each, and after the client
   exits hard its actor dead and its object freed; (d) a wheel built
   here, offline, as a pip runtime_env of a `num_gpus=1` task that
   imports it and the system's torch, sees this card and runs K1 once
   against its plain version; a task without the env cannot import it.
   A stage, step, task or actor asked for the card that sees none raises.
   Prints ms per request each way beside this process's forward, the
   workflow's first run and resume, and the client's seconds to connect
   and per call;
27. Mixtral's other meshes, a C caller, and the native libraries:
   (a) mixtral-small at full width and depth (b2 s2048, bf16 parameters,
   remat "dots", `moe_lm_loss` with AdamW) over 4 ranks sharing the card
   in one world (`run_mixtral_trains`), on MESH_CASES: data 2 x expert 2
   with "gmm" (each expert rank's own pairs through K4 and K5), seq 2 x
   expert 2 with "capacity" (positions over the whole sequence) and data
   2 x tensor 2 with "capacity" (heads and each expert's F split, every
   exchange an all-reduce, which gloo carries through host memory; in
   float32 parameters and compute on the mesh and on one card, where a
   bf16 router near-tie would decide the comparison); one step and
   MESH_TIMED_STEPS timed each: every loss within RING_LOSS_RTOL of the
   same steps on one card with the same dispatch and dtype, finite and
   falling, the ranks holding the same part of the model equal and the
   unsplit parameters equal on all four, K1-K5 launched over the ranks as
   often as the mesh implies (`mesh_launches`); each rank's step and peak
   memory, host-staged and not a measure of scaling; (b) the port's C
   client driver (`native_tools`, built here at first use) calls a
   `num_gpus=1` actor holding SERVE_MODEL (seed 0, bf16) over its
   worker's direct socket: the prompt's int32 ids as bytes in, the
   greedy next token and the last row's float32 logits as bytes out,
   both bitwise this process's forward of the prompt, K1 once per layer
   per call in the actor; ms per call beside this process's forward;
   (c) the runtime's native object store and codec built from
   `ray_tpu_torch/_private/csrc/` and live (a failed build fails the
   phase; nothing falls back);
28. the runtime under faults, on a runtime of the phase's own under a
   temp root of its own, with a seeded chaos schedule (FAULT_SPEC, seed
   FAULT_SEED, printed) in every process of it, delaying and duplicating
   task and return messages at the transport, and the lock witness armed
   in every process (`RAY_TPU_TORCH_lock_witness=1`, one sidecar file);
   both are removed after the phase. (a) A `num_gpus=1`,
   `max_restarts=1` actor builds SERVE_MODEL from weights this process
   put in the object store and answers phase 23's requests; after
   FAULT_KILL_AFTER answers its worker is SIGKILLed, and the restarted
   actor answers the rest from a new pid on this card: every row within
   SERVE_LOGITS_REL of this process's forward, K1 once per layer per
   answer in each incarnation. (b) A `num_gpus=1`, `max_retries=1` task
   takes FAULT_STEPS of phase 5's steps; the chaos rule FAULT_KILL_RULE
   kills its first attempt after its first step, and the retry's losses
   are phase 5's first FAULT_STEPS bitwise, K1-K3 2L/L/L a step in its
   worker. (c) No lock-order inversion in any process of (a) and (b).
   Prints the seconds of the put, the actor's start and restart (split
   into the wait for its constructor, its get, build and load) and the
   retry, and the faults injected in each worker.
30. the layouts with one card per rank over NCCL, where the host has
   NCCL_RANKS cards or more (on fewer, one line with the count and
   nothing else; nothing moves to gloo, host memory or the CPU). Phases
   1-29 are written for one card: on a host with several this process
   sees only its first (`pin_to_one_card`), and so does every process
   it starts before this phase; the phase's worlds and runtime see them
   all, rank r on card r (`parallel.launch.spawn(..., backend="nccl")`).
   (a) llama-1b sequence-parallel over seq 4 at T 32768, all 22 layers,
   chunked loss, against the same steps on one card (RING_LOSS_RTOL),
   with each rank's step and the time its kernels waited for the k/v
   shifts (CUDA events around `Shift.wait`); (b) 4 pipeline stages of
   NCCL_PIPE_LAYERS layers, NCCL_PIPE_MICRO microbatches of b1 s2048,
   against the layers in sequence on one card as phase 15 holds them,
   with each stage's idle share of the schedule from CUDA events around
   its ticks; (c) phase 27a's MESH_CASES on four cards, with each rank's
   expert all-reduce ms; (d) `TorchTrainer` of NCCL_RANKS GPU workers
   joined over NCCL by the trainer's rendezvous, b2 s2048 of llama-1b
   each, gradients averaged, against one card's accumulation over the
   same global batch; (e) `shard_params` on fsdp 2 x tensor 2 (tensor
   plan, then FSDP2), phase 5's steps against phase 5's losses, with
   each rank's peak memory beside phase 5's. K1-K5 counted per rank.

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
# One timed step after the warm-up: a sequence-parallel step takes about
# 34 s through host memory, and the whole smoke must stay well inside its
# time limit as phases are added.
RING_TIMED_STEPS, RING_CHUNK = 1, 2048
# The sequence-parallel steps at full width and half of llama-1b's depth:
# 22 layers took 35 s a step, and the smoke's total passed its 850 s aim.
RING_LAYERS = 11
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
# Phase 26: the rest of the surface. Requests drawn as phase 23 draws
# them; every logits row held to SERVE_LOGITS_REL of this process's
# forward of the same ids (the same bf16 weights and kernels at batch 1).
# 26d runs K1 once at this shape in the pip env's task.
SURFACE_REQUESTS = 16
SURFACE_TIMEOUT_S = 300
SURFACE_EVENT_KEY = "chip-smoke/surface"
CLIENT_ACTOR = "chip-smoke-client-llama"
CLIENT_RESULT_TAG = "CLIENT_RESULT "
PIP_ATTN = dict(bh=32, t=2048, d=128)
# Phase 27a: mixtral-small's other meshes, each (label, axes, dispatch,
# dtype of parameters and compute, None for the phase's bf16), 4 ranks
# sharing the card in one world, one step and MESH_TIMED_STEPS timed on
# each. The tensor axis splits every attention and expert product's
# reduction: in bf16 its partials round apart from one card's products,
# and a router near-tie then moves tokens between experts on one side
# only, which decides a 1e-3 loss comparison either way (this phase's
# first bf16 runs read 1.35e-3 and 1.15e-3). In float32 on both sides the
# comparison holds the split itself. One timed step each keeps the whole
# smoke near its time budget once phase 28 runs too.
MESH_CASES = (
    ("expert gmm", dict(data=2, expert=2), "gmm", None),
    ("seq x expert capacity", dict(seq=2, expert=2), "capacity", None),
    ("tensor capacity", dict(data=2, tensor=2), "capacity", "float32"),
)
MESH_TIMED_STEPS = 1
# `--phase 30c-bf16`: the tensor case in bf16 on both sides, a measurement
# the default run does not make: BF16_SPLIT_STEPS steps of mixtral-small on
# data x tensor over NCCL beside the same steps on one card, with the loss
# gap and the tokens whose top-k experts the split moved, per step and
# layer.
BF16_SPLIT_AXES = dict(data=2, tensor=2)
BF16_SPLIT_STEPS = 8
# Phase 27b: the C client's prompt (ids from RandomState(2)) and its calls.
C_PROMPT_LEN, C_CALLS = 512, 10
# Phase 28: the runtime under faults, on a runtime of the phase's own with
# a seeded chaos schedule. FAULT_SPEC delays and duplicates task and return
# messages where the transport delivers them: a task pushed to its worker
# (execute_task) and an actor call (op_call) are delayed, a worker's batch
# of finished tasks (task_done_batch) and an actor's reply (op_reply) are
# duplicated and delayed. Each duplicate must be dropped by its receiver
# (the batches' sequence numbers, the replies' request ids). 28a SIGKILLs
# the actor's worker after FAULT_KILL_AFTER of phase 23's requests; 28b's
# task takes FAULT_STEPS of phase 5's steps, and the rule
# FAULT_KILL_RULE kills its first attempt after its first step (each
# attempt passes the kill point FAULT_KILL_POINT.attempt<a>.step<s>).
FAULT_SEED = 0x28FA
FAULT_SPEC = ("execute_task=delay:0.3:1000:20000,op_call=delay:0.3:1000:20000,"
              "task_done_batch=dup:0.3,task_done_batch=delay:0.3:1000:20000,"
              "op_reply=dup:0.3,op_reply=delay:0.3:1000:20000")
FAULT_KILL_POINT = "chip_smoke.faults"
FAULT_KILL_RULE = f"kill:{FAULT_KILL_POINT}.attempt0.step1=1?role=worker"
FAULT_KILL_AFTER = SERVE_REQUESTS // 2
FAULT_STEPS = 2
FAULT_TIMEOUT_S = 300
# Phase 29: a GPU actor observed through the runtime's own instruments, on
# a runtime of its own with the dashboard up. One num_gpus=1 actor with
# the concurrency groups OBSERVED_GROUPS, in a STRICT_PACK placement group
# of one {"GPU": 1, "CPU": 1} bundle, streams OBSERVED_STEPS of phase 5's
# train steps (its "compute" group) while OBSERVED_IO_CALLS calls of its
# "io" group read its step count; a num_gpus=1 task outside the group
# waits OBSERVED_PENDING_S and is cancelled; the actor counts its steps in
# the user counter OBSERVED_COUNTER, which /metrics must serve.
OBSERVED_STEPS = 3
OBSERVED_IO_CALLS = 3
OBSERVED_GROUPS = {"compute": 1, "io": 1}
OBSERVED_COUNTER = "chip_smoke_observed_steps"
OBSERVED_PENDING_S = 2.0
OBSERVED_TIMEOUT_S = 300
# Phase 30: the layouts with one card per rank over NCCL, on a host with
# NCCL_RANKS cards. 30b's pipeline: NCCL_RANKS stages of NCCL_PIPE_LAYERS
# of llama-1b's 22 layers (stages are equal, so 20), NCCL_PIPE_MICRO
# microbatches of b1 s2048. 30d's TorchTrainer: NCCL_TRAINER_BATCH rows a
# worker. 30a, 30b and 30d take one step and NCCL_TIMED_STEPS timed; 30c
# takes 27a's and 30e phase 5's. Each world's deadline is NCCL_DEADLINE_S.
NCCL_RANKS = 4
NCCL_PIPE_LAYERS, NCCL_PIPE_MICRO = 5, 8
NCCL_TRAINER_BATCH = 2
NCCL_SHARDED = dict(fsdp=2, tensor=2)
NCCL_TIMED_STEPS = 2
NCCL_DEADLINE_S = 300
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


#: The smoke's start and the end of each phase that has finished.
_PHASE_CLOCK = [time.perf_counter()]


def phase_done(label: str) -> None:
    """Prints the seconds phase `label` took and the smoke's time so far."""
    now = time.perf_counter()
    print(f"phase {label}: {now - _PHASE_CLOCK[-1]:.1f} s, smoke at "
          f"{now - _PHASE_CLOCK[0]:.1f} s", flush=True)
    _PHASE_CLOCK.append(now)


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

    def routed(tokens, experts, skip=(), block_m=128, keep=None):
        """(dst, tile_group, m) of a top-2 layout of random router logits,
        with the experts in `skip` never chosen; with `keep` (a range of
        experts), only the pairs routed there, with local ids, as one
        expert rank of a mesh lays them out (`MoELayer._gmm`)."""
        logits = torch.randn(tokens, experts, generator=gen, device="cuda")
        logits[:, list(skip)] = -math.inf
        e_flat = logits.topk(MOE_TOPK, dim=-1).indices.reshape(-1)
        if keep is not None:
            e_flat = e_flat[(e_flat >= keep.start) & (e_flat < keep.stop)] - keep.start
            experts = len(keep)
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
    # One expert rank of phase 27a's data 2 x expert 2 "gmm": its data
    # rank's b1 s2048 tokens, the pairs routed to experts 0-3 of 8.
    local = range(e // 2)
    dst, tile_group, m = routed(MOE_TOKENS // 2, e, keep=local)
    check(tile_group.numel() * 128 == m and m < 9216 // 2,
          f"expert rank's layout: m_pad {m} over {tile_group.numel()} tiles")
    case(f"expert rank 0 of 2, m{m} k{MOE_D} n{MOE_F}", dst, tile_group, m, len(local),
         MOE_D, MOE_F)
    case(f"expert rank 0 of 2, down m{m} k{MOE_F} n{MOE_D}", dst, tile_group, m, len(local),
         MOE_F, MOE_D)
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


def check_seq_parallel(label, res, single, layers: int, n: int, steps: int):
    """The sequence-parallel train steps of `res` (`run_llama_train` on
    each of `n` ranks of a seq group, `layers` layers, `steps` steps with
    the warm-up) against the same steps on one card (`single`, their
    losses): every loss within RING_LOSS_RTOL, falling, the parameters
    equal on every rank, and the ring's launches over the ranks. Returns
    (losses, largest relative difference, launches, launches per step,
    slowest rank's step ms)."""
    from ray_tpu_torch.ops import attention as A

    losses = res[0]["losses"]
    digests = [r["param_digest"] for r in res]
    check(all(x == digests[0] for x in digests),
          f"{label}: ranks hold different parameters after the steps: digests {digests}")
    check(all(math.isfinite(x) for x in losses), f"{label}: loss not finite: {losses}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    check(max(loss_rel) <= RING_LOSS_RTOL,
          f"{label}: losses {losses} vs single-card {single}: relative "
          f"{loss_rel} (rtol {RING_LOSS_RTOL})")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    launches = {name: sum(r["launches"][name] for r in res) for name in A.LAUNCHES}
    # remat "nothing": each layer's ring forward runs twice (forward and
    # recompute), its backward once; each pass launches n(n + 1) / 2
    # kernels over the ranks (rank r runs r + 1 blocks).
    blocks = n * (n + 1) // 2
    per_step = {"flash_fwd": 2 * layers * blocks, "flash_bwd_dkv": layers * blocks,
                "flash_bwd_dq": layers * blocks}
    for name, k in per_step.items():
        check(launches[name] == k * steps,
              f"{label}: {name} launched {launches[name]} times over the ranks "
              f"in {steps} steps, expected {k * steps}")
    return losses, max(loss_rel), launches, per_step, max(r["step_ms"] for r in res)


def phase_ring(A, card):
    """Ring attention and the sequence-parallel llama-1b step over
    RING_RANKS processes sharing the card, in one world through
    `parallel.launch`. Returns the slowest rank's step ms and the layers
    it ran."""
    import functools
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, chunked_causal_lm_loss
    from ray_tpu_torch.parallel.launch import ring_inputs, run_ring_then_train, spawn
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
    # (b) the sequence-parallel llama-1b train steps against the same
    # steps on one card, from the same weights and ids
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16, num_layers=RING_LAYERS)
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
    # Both in one world of RING_RANKS processes.
    t0 = time.perf_counter()
    res = spawn(run_ring_then_train, n, spec, [dict(inputs=inputs, causal=True, dtype="bfloat16")],
                cfg, ids, RING_TIMED_STEPS, loss_fn, deadline_s=900)
    seconds = time.perf_counter() - t0
    parts = sorted((r[0][0] for r in res), key=lambda r: r["seq_rank"])
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
          f"limit rel {REL_TOL}; launches over the ranks {launches}: ok", flush=True)
    del want

    res = [r[1] for r in res]
    steps, layers = RING_TIMED_STEPS + 1, cfg.num_layers
    losses, loss_rel, launches, per_step, step_ms = check_seq_parallel(
        "sequence-parallel step", res, single, layers, n, steps)
    for r in sorted(res, key=lambda r: r["seq_rank"]):
        print(f"seq-parallel rank {r['seq_rank']}: backend {r['backend']}, {r['device']} "
              f"({r['card']}), step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"train llama-1b seq-parallel ({layers} layers, seq {n}, b1, T {t}, bf16, chunked "
          f"loss) on {card}, "
          f"{n} ranks sharing the card over gloo through host memory: losses "
          f"{losses} against single-card {single} (relative {loss_rel:.2e}, rtol "
          f"{RING_LOSS_RTOL}), parameters equal on every rank, step {step_ms:.1f} ms "
          f"(slowest rank; one card alone {single_s / RING_TIMED_STEPS * 1e3:.1f} ms), "
          f"{t / step_ms * 1e3:.1f} "
          f"tokens/s, launches over the ranks {launches} ({per_step} per step); world of "
          f"{n} processes, the ring then the steps, in {seconds:.1f} s: ok; not a measure of "
          f"scaling (one card, host-staged exchange)", flush=True)
    print("FSDP and tensor parallelism (parallel.mesh.shard_params) are not run on one card: "
          "gloo has no all-gather or reduce-scatter of CUDA tensors and NCCL refuses two "
          "ranks on a card; they run in the CPU tests over gloo and, with a card per rank "
          "over NCCL, in phase 30", flush=True)
    return {"step_ms": step_ms, "layers": layers}


def _grad_rows(g):
    """A gradient as rows for `rel_errs`: [out, in] weights by output row
    (tiles of TILE), a vector as one row (tile 1)."""
    return (g.reshape(-1, g.shape[-1]), TILE) if g.dim() > 1 else (g.reshape(1, -1), 1)


def check_pipeline(label, res, want, layers: int, m_count: int, steps: int, device=None):
    """The pipeline's ranks `res` (`run_pipeline_llama`, `layers` layers a
    stage, `m_count` microbatches, `steps` steps with the warm-up) against
    the same layers in sequence on one card (`want`, `sequential_llama`):
    y and every gradient (compared on `device`, where given), the losses,
    and each rank's launches. Returns the worst normwise errors."""
    def on(t):
        return (t if device is None else t.to(device)).float()

    errs = []
    for r in res:
        errs.append(assert_close(f"{label} y (stage {r['stage']}) vs sequential",
                                 on(r["y"]), on(want["y"]), O_TOL, O_TOL, REL_TOL))
        grads = want["grads"][r["stage"]]
        check(set(r["grads"]) == set(grads), f"{label} stage {r['stage']}: other parameters")
        for name, w in grads.items():
            (got, tile), (ref, _) = _grad_rows(on(r["grads"][name])), _grad_rows(on(w))
            errs.append(assert_close(f"{label} grad {name} (stage {r['stage']})", got, ref,
                                     GRAD_TOL * float(ref.abs().max()), GRAD_TOL, REL_TOL,
                                     tile=tile))
    for r in res:
        losses = r["losses"]
        check(all(math.isfinite(x) for x in losses), f"{label} loss not finite: {losses}")
        check(losses[-1] < losses[0], f"{label} loss did not fall: {losses}")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
        check(max(loss_rel) <= RING_LOSS_RTOL,
              f"{label} losses {losses} vs sequential {want['losses']}: relative {loss_rel} "
              f"(rtol {RING_LOSS_RTOL})")
        # Each rank runs its layers on the M microbatches of its own
        # ticks only: K1 in the forward and again in remat "nothing"'s
        # recompute inside the backward's VJP, K2 and K3 once.
        per_step = {"flash_fwd": 2 * m_count * layers, "flash_bwd_dkv": m_count * layers,
                    "flash_bwd_dq": m_count * layers}
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"{label} stage {r['stage']}: {name} launched {r['launches'][name]} times "
                  f"in {steps} steps, expected {k * steps}")
    return errs, per_step


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
    errs, per_step = check_pipeline("pipeline", res, want, layers, m_count, TIMED_STEPS + 1,
                                    "cuda")
    for r in res:
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
          f"(S-1)/(M+S-1) = {(s_count - 1) / (m_count + s_count - 1):.2f} (the schedule's; "
          f"phase 30 measures it with a card per stage); launches per rank {per_step} per "
          f"step; world in {seconds:.1f} s: "
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
    torch.cuda.reset_peak_memory_stats()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9  # phase 30e's yardstick
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


# ----------------------------------------------------------------- phase 26


def surface_spec(**over):
    """What phase 26 runs: SERVE_MODEL on the card, phase 23's draw of
    SURFACE_REQUESTS requests, phase 5's batch for the workflow's steps.
    The CPU rehearsal (tests/test_torch_surface_phase.py) overrides the
    model, the device and the sizes."""
    spec = {"model": SERVE_MODEL, "device": "cuda", "requests": SURFACE_REQUESTS,
            "min_len": SERVE_MIN_LEN, "max_len": SERVE_MAX_LEN, "batch": BATCH, "seq": SEQ,
            "steps": TIMED_STEPS + 1, "num_cpus": None}
    spec.update(over)
    return spec


def surface_model(spec):
    """spec's Llama on spec's device, seed 0, bf16 parameters, as phase 23
    builds SERVE_MODEL. A worker asked for the card that sees none raises:
    nothing falls back to the CPU."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    if spec["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("phase 26: a worker asked for the card sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(CONFIGS[spec["model"]], param_dtype=torch.bfloat16)
    return LlamaForCausalLM(cfg, device=spec["device"])


def surface_logits(model, ids, device):
    """The last position's logits of one request, float32 on `device`."""
    import torch

    with torch.inference_mode():
        hidden = model(torch.as_tensor([ids], device=device), return_hidden=True)
        return model.lm_head(hidden[:, -1]).float()[0]


def surface_worker_stats():
    """This worker's card, visible devices and K1-K3 launches."""
    import os

    import torch

    from ray_tpu_torch.ops import attention as A

    return {"card": torch.cuda.get_device_name() if torch.cuda.is_available() else None,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "launches": dict(A.LAUNCHES)}


class SurfaceLlamaStage:
    """26a's stage 1: the model on the card; `forward` returns a request's
    last-position logits as the card's tensor, as a user would write it."""

    def __init__(self, spec):
        self.spec = spec
        self.model = surface_model(spec)

    def forward(self, ids):
        return surface_logits(self.model, ids, self.spec["device"])

    def reset(self):
        from ray_tpu_torch.ops import attention as A

        A.reset_launch_counts()

    def stats(self):
        return surface_worker_stats()


class SurfaceArgmax:
    """26a's stage 2, on the CPU: the next token, and what reached it."""

    def __init__(self):
        self.seen = set()

    def apply(self, logits):
        self.seen.add((type(logits).__name__, logits.device.type, str(logits.dtype),
                       tuple(logits.shape)))
        return logits, int(logits.argmax())

    def reset(self):
        self.seen = set()

    def stats(self):
        return sorted(self.seen)


def surface_count(counter_dir, name):
    """One line in `counter_dir/name` per run of a workflow step."""
    import os

    with open(os.path.join(counter_dir, name), "a") as f:
        f.write("1\n")


def surface_make_batches(spec, counter_dir):
    """26b's first step: phase 5's ids, from RandomState(0)."""
    import numpy as np

    from ray_tpu_torch.models.llama import CONFIGS

    surface_count(counter_dir, "make_batches")
    vocab = CONFIGS[spec["model"]].vocab_size
    return np.random.RandomState(0).randint(0, vocab, (spec["batch"], spec["seq"]))


def surface_train(ids, spec, counter_dir):
    """26b's second step, on the card: phase 5's llama-1b steps (a warm-up
    and TIMED_STEPS more on the one batch), K1-K3 counted here."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as A

    surface_count(counter_dir, "train")
    model = surface_model(spec)
    optimizer = train.make_optimizer(model)
    ids = torch.tensor(ids, dtype=torch.long, device=spec["device"])  # a copy: ids is read-only
    targets = torch.roll(ids, -1, dims=1)
    A.reset_launch_counts()
    losses = [float(train.train_step(model, optimizer, ids, targets))
              for _ in range(spec["steps"])]
    return {"losses": losses, **surface_worker_stats()}


def surface_summarize(result, flag, counter_dir):
    """26b's last step. Its first attempt fails, as a transient fault
    would: `resume` must then run it alone."""
    import os

    surface_count(counter_dir, "summarize")
    if not os.path.exists(flag):
        open(flag, "w").close()
        raise RuntimeError("summarize: a transient fault on the first attempt")
    return {"final_loss": result["losses"][-1], **result}


def surface_event_payload(event):
    return event["source"]


def client_forward_task(ids, spec):
    """26c's task, submitted by the thin client: the model's forward of
    one request on the card, K1 counted here."""
    from ray_tpu_torch.ops import attention as A

    model = surface_model(spec)
    A.reset_launch_counts()
    return surface_logits(model, ids, spec["device"]), surface_worker_stats()


class ClientLlama:
    """26c's actor, created by the thin client: the model on the card."""

    def __init__(self, spec):
        self.spec = spec
        self.model = surface_model(spec)

    def forward(self, ids):
        from ray_tpu_torch.ops import attention as A

        A.reset_launch_counts()
        return surface_logits(self.model, ids, self.spec["device"]), surface_worker_stats()


def client_driver(address, spec_json, out_path) -> int:
    """`chip_smoke.py --client-driver ADDRESS SPEC OUT`, 26c's client: a
    driver whose only route to the cluster is the `ray_tpu_torch://`
    address, started with CUDA_VISIBLE_DEVICES empty. It runs the task
    and the actor, saves what it got to OUT, prints its timings and exits
    hard, so the session alone must clean up."""
    import torch

    import ray_tpu_torch as rt

    spec = json.loads(spec_json)
    gpus = 1 if spec["device"] == "cuda" else 0
    t0 = time.perf_counter()
    rt.init(address=address)
    connect_s = time.perf_counter() - t0
    ids = spec["request"]
    task = rt.remote(num_gpus=gpus)(client_forward_task)
    times = {}
    t0 = time.perf_counter()
    task_logits, task_stats = rt.get(task.remote(ids, spec), timeout=SURFACE_TIMEOUT_S)
    times["task_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.get(task.remote(ids, spec), timeout=SURFACE_TIMEOUT_S)
    times["task_s"] = time.perf_counter() - t0
    actor = rt.remote(num_gpus=gpus)(ClientLlama).options(name=CLIENT_ACTOR).remote(spec)
    t0 = time.perf_counter()
    actor_logits, actor_stats = rt.get(actor.forward.remote(ids), timeout=SURFACE_TIMEOUT_S)
    times["actor_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.get(actor.forward.remote(ids), timeout=SURFACE_TIMEOUT_S)
    times["actor_s"] = time.perf_counter() - t0
    held = rt.put(torch.arange(1 << 16))
    torch.save({"task": task_logits, "actor": actor_logits}, out_path)
    print(CLIENT_RESULT_TAG + json.dumps({
        "connect_s": connect_s, **times, "task": task_stats, "actor": actor_stats,
        "held": held.hex(), "client_sees_cuda": torch.cuda.is_available()}), flush=True)
    os._exit(0)  # no shutdown: the head's session must clean up alone


def make_wheel(directory, name, version="1.0", body="VALUE = 42\n"):
    """A hand-rolled wheel (a zip with its dist-info) that pip installs
    offline, as tests/test_runtime_env.py builds one."""
    import base64
    import hashlib
    import zipfile

    whl = os.path.join(directory, f"{name}-{version}-py3-none-any.whl")
    dist = f"{name}-{version}.dist-info"
    files = {
        f"{name}/__init__.py": body,
        f"{dist}/METADATA": f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n",
        f"{dist}/WHEEL": ("Wheel-Version: 1.0\nGenerator: chip_smoke\nRoot-Is-Purelib: true\n"
                          "Tag: py3-none-any\n"),
    }
    records = []
    with zipfile.ZipFile(whl, "w") as zf:
        for path, content in files.items():
            data = content.encode()
            zf.writestr(path, data)
            digest = base64.urlsafe_b64encode(hashlib.sha256(data).digest()).rstrip(b"=").decode()
            records.append(f"{path},sha256={digest},{len(data)}")
        records.append(f"{dist}/RECORD,,")
        zf.writestr(f"{dist}/RECORD", "\n".join(records) + "\n")
    return whl


def pip_env_task(spec):
    """26d's task, in the pip env: imports the wheel and the system's
    torch, sees the card and runs K1 once against its plain version."""
    import math

    import torch

    import rtpt_smoke_pkg
    from ray_tpu_torch.ops import attention as A

    if spec["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("phase 26d: the pip env's task sees no CUDA card")
    gen = torch.Generator(device=spec["device"]).manual_seed(0)
    q, k, v = (torch.randn(PIP_ATTN["bh"], PIP_ATTN["t"], PIP_ATTN["d"], generator=gen,
                           device=spec["device"]).to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, sm_scale=1.0 / math.sqrt(PIP_ATTN["d"]))
    A.reset_launch_counts()
    o, _ = A.flash_fwd(q, k, v, **kw)
    launches = dict(A.LAUNCHES)
    o_plain, _ = A._flash_fwd_plain(q.float(), k.float(), v.float(), **kw)
    return {"value": rtpt_smoke_pkg.VALUE, "pkg_file": rtpt_smoke_pkg.__file__,
            "torch_file": torch.__file__, "max_abs_err": float((o.float() - o_plain).abs().max()),
            **surface_worker_stats(), "launches": launches}


def pip_absent_task():
    try:
        import rtpt_smoke_pkg  # noqa: F401
    except ImportError:
        return "isolated"
    return "leaked"


def _channel_entries(compiled):
    """A compiled DAG's shared-memory segments and semaphores, as entries
    of /dev/shm."""
    out = []
    for ch in compiled._all_channels:
        base = ch.name.strip("/")
        out += [f"/dev/shm/{base}", f"/dev/shm/sem.{base}.i", f"/dev/shm/sem.{base}.s"]
    return out


def phase_surface(card, in_process, spec=None, parts="abcd"):
    """Phase 26: a compiled DAG serving the model (a), a workflow that
    trains on the card and resumes (b), a thin client driving the card
    (c) and a pip runtime_env on the card (d), all on a runtime of the
    phase's own under a temp root of its own, each held against this
    process's model or phase 5's losses (`in_process`). With a spec whose
    device is the CPU (the rehearsal), the checks that need the card are
    listed, not made. Returns each part's K1-K3 launches and the list of
    skipped checks."""
    import shutil
    import socket
    import subprocess
    import threading
    import urllib.request

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.util.state import list_actors, list_objects

    spec = spec or surface_spec()
    device = spec["device"]
    on_card = device == "cuda"
    card_name = torch.cuda.get_device_name(0) if on_card else None
    gpus = 1 if on_card else 0
    layers = CONFIGS[spec["model"]].num_layers
    vocab = CONFIGS[spec["model"]].vocab_size
    skipped = []

    def card_check(ok, what):
        if on_card:
            check(ok, what)
        else:
            skipped.append(what.split(":")[0])

    def sync():
        if on_card:
            torch.cuda.synchronize()

    lengths = np.random.RandomState(0).randint(spec["min_len"], spec["max_len"] + 1,
                                               spec["requests"])
    ids_rng = np.random.RandomState(1)
    requests = [ids_rng.randint(0, vocab, n).tolist() for n in lengths]
    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="rtpt")
    saved_root = os.environ.get("RAY_TPU_TORCH_TEMP_DIR")
    os.environ["RAY_TPU_TORCH_TEMP_DIR"] = root
    # The oracle: the model in this process, built as every worker builds it.
    model = surface_model(spec)
    want = [surface_logits(model, r, device).cpu() for r in requests]

    def hold(name, got, r, want_row, token=None):
        """A row of logits (and its next token) against the oracle's."""
        got = torch.as_tensor(got)
        check(got.device.type == "cpu" and got.dtype == torch.float32,
              f"{name}: logits arrived as {got.device} {got.dtype}, not a host float32 tensor")
        rel = float((got - want_row).norm() / want_row.norm())
        check(bool(torch.isfinite(got).all()) and got.shape == want_row.shape
              and rel <= SERVE_LOGITS_REL,
              f"{name}: a request of {len(r)} tokens: logits relative error {rel:.3e}")
        if token is not None:
            top2 = want_row.topk(2).values
            diff = float((got - want_row).abs().max())
            check(token == int(want_row.argmax()) or float(top2[0] - top2[1]) <= diff,
                  f"{name}: a request of {len(r)} tokens: next token {token}, alone "
                  f"{int(want_row.argmax())} (top-2 gap {float(top2[0] - top2[1]):.3e}, "
                  f"largest difference {diff:.3e})")
        return rel

    launches, worst = {}, {}
    init_kw = {} if spec["num_cpus"] is None else {"num_cpus": spec["num_cpus"]}
    rt.init(client_server_port=0, **init_kw)
    try:
        if "a" in parts:
            # 26a. a compiled DAG serving the model, three ways
            stage = rt.remote(num_gpus=gpus)(SurfaceLlamaStage).remote(spec)
            argmax = rt.remote(num_gpus=0)(SurfaceArgmax).remote()
            rt.get(argmax.apply.remote(stage.forward.remote(requests[0])),
                   timeout=SURFACE_TIMEOUT_S)  # both workers up, the model built and warm
            rt.get([stage.reset.remote(), argmax.reset.remote()], timeout=SURFACE_TIMEOUT_S)
            with InputNode() as inp:
                dag = argmax.apply.bind(stage.forward.bind(inp))
            compiled = dag.experimental_compile(submit_timeout=SURFACE_TIMEOUT_S)
            entries = _channel_entries(compiled)
            check(entries and all(os.path.exists(e) for e in entries),
                  f"26a: the DAG's channels are not all in /dev/shm: {entries}")
            out, ms = {}, {}
            t0 = time.perf_counter()
            out["execute"] = [compiled.execute(r) for r in requests]
            ms["execute"] = (time.perf_counter() - t0) * 1e3 / len(requests)
            t0 = time.perf_counter()
            feeder = threading.Thread(target=lambda: [compiled.submit(r) for r in requests])
            feeder.start()
            out["submit/collect"] = [compiled.collect() for _ in requests]
            feeder.join()
            ms["submit/collect"] = (time.perf_counter() - t0) * 1e3 / len(requests)
            compiled.teardown()
            left = [e for e in entries if os.path.exists(e)]
            check(not left, f"26a: left after teardown(): {left}")
            dag_stats = rt.get(stage.stats.remote(), timeout=SURFACE_TIMEOUT_S)
            dag_seen = rt.get(argmax.stats.remote(), timeout=SURFACE_TIMEOUT_S)
            rt.get([stage.reset.remote(), argmax.reset.remote()], timeout=SURFACE_TIMEOUT_S)
            t0 = time.perf_counter()
            out[".remote()"] = [rt.get(argmax.apply.remote(stage.forward.remote(r)),
                                       timeout=SURFACE_TIMEOUT_S) for r in requests]
            ms[".remote()"] = (time.perf_counter() - t0) * 1e3 / len(requests)
            rpc_stats = rt.get(stage.stats.remote(), timeout=SURFACE_TIMEOUT_S)
            rt.kill(stage)  # the card is the next part's
            check(dag_seen == [("Tensor", "cpu", "torch.float32", (vocab,))],
                  f"26a: stage 2 got {dag_seen} through the channel, not host float32 tensors")
            for way, rows in out.items():
                worst[way] = max(hold(f"26a {way}", got, r, w, token)
                                 for (got, token), r, w in zip(rows, requests, want))
            n = len(requests)
            card_check(dag_stats["card"] == card_name,
                       f"26a card: stage 1 ran on {dag_stats['card']!r}")
            card_check(dag_stats["launches"] == {"flash_fwd": 2 * n * layers, "flash_bwd_dkv": 0,
                                                 "flash_bwd_dq": 0},
                       f"26a launches: stage 1 launched {dag_stats['launches']} for {2 * n} "
                       f"requests through the DAG, expected {layers} flash_fwd each")
            card_check(rpc_stats["launches"]["flash_fwd"] == n * layers,
                       f"26a launches .remote(): stage 1 launched {rpc_stats['launches']} for {n} "
                       f"requests")
            launches["dag"] = dag_stats["launches"]["flash_fwd"]
            here = []
            with torch.inference_mode():
                for r in requests:
                    sync()
                    t0 = time.perf_counter()
                    surface_logits(model, r, device)
                    sync()
                    here.append((time.perf_counter() - t0) * 1e3)
            print(f"compiled DAG {spec['model']} on {card}: {n} requests of T "
                  f"{spec['min_len']}-{spec['max_len']} ({int(lengths.sum())} tokens), stage 1 "
                  f"num_gpus={gpus} on {dag_stats['card']} (CUDA_VISIBLE_DEVICES="
                  f"{dag_stats['visible']}), stage 2 num_gpus=0 received {dag_seen}; ms per "
                  f"request: execute {ms['execute']:.2f}, submit/collect with the pipe full "
                  f"{ms['submit/collect']:.2f}, the same actors through .remote() "
                  f"{ms['.remote()']:.2f}, this process's forward {float(np.mean(here)):.2f}; "
                  f"worst relative error {worst}; launches through the DAG "
                  f"{dag_stats['launches']}, through .remote() {rpc_stats['launches']}; "
                  f"after teardown() none of its {len(entries)} rtpt_ segments and semaphores "
                  f"left: ok", flush=True)

        if "b" in parts:
            # 26b. a workflow that trains on the card and resumes
            wf_dir, counters = os.path.join(root, "workflows"), os.path.join(root, "counters")
            os.makedirs(counters)
            workflow.init(wf_dir)
            flag = os.path.join(root, "summarize-failed-once")
            make_batches = rt.remote(num_gpus=0)(surface_make_batches)
            train_task = rt.remote(num_gpus=gpus)(surface_train)
            summarize = rt.remote(num_gpus=0)(surface_summarize)
            dag = summarize.bind(train_task.bind(make_batches.bind(spec, counters), spec, counters),
                                 flag, counters)
            t0 = time.perf_counter()
            try:
                workflow.run(dag, workflow_id="chip-smoke-train")
            except Exception as e:  # noqa: BLE001 - the planned first failure, checked next
                first_error = repr(e)
            else:
                check(False, "26b: the workflow's first run did not fail")
            first_s = time.perf_counter() - t0
            check("transient fault" in first_error, f"26b: the first run failed with {first_error}")
            check(workflow.get_status("chip-smoke-train") == "FAILED",
                  f"26b: status {workflow.get_status('chip-smoke-train')} after the failure")
            t0 = time.perf_counter()
            result = workflow.resume("chip-smoke-train")
            resume_s = time.perf_counter() - t0
            runs = {name: len(open(os.path.join(counters, name)).readlines())
                    for name in sorted(os.listdir(counters))}
            check(runs == {"make_batches": 1, "summarize": 2, "train": 1},
                  f"26b: steps ran {runs} times across the resume, not make_batches and train "
                  f"once, summarize twice")
            check(workflow.get_status("chip-smoke-train") == "SUCCESSFUL",
                  f"26b: status {workflow.get_status('chip-smoke-train')} after the resume")
            rel = [abs(a - b) / abs(b) for a, b in zip(result["losses"], in_process["losses"])]
            check(len(rel) == spec["steps"] and max(rel) <= TRAINER_LOSS_RTOL,
                  f"26b: losses {result['losses']} vs phase 5's {in_process['losses']}: "
                  f"relative {rel}")
            per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
            card_check(result["card"] == card_name,
                       f"26b card: the training step ran on {result['card']!r}")
            card_check(result["launches"] == {k: v * spec["steps"] for k, v in per_step.items()},
                       f"26b launches: the training step launched {result['launches']} in "
                       f"{spec['steps']} steps, expected {per_step} per step")
            launches["workflow"] = result["launches"]
            event = "not run (no aiohttp)"
            try:
                import aiohttp  # noqa: F401
            except ImportError:
                pass
            else:
                from ray_tpu_torch.dashboard import start_dashboard

                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    dash_port = s.getsockname()[1]
                url = start_dashboard(port=dash_port)
                echo = rt.remote(num_gpus=0)(surface_event_payload)
                fut = workflow.run_async(echo.bind(workflow.wait_for_event(
                    SURFACE_EVENT_KEY, timeout_s=SURFACE_TIMEOUT_S)), workflow_id="chip-smoke-event")
                time.sleep(0.5)
                check(not fut.done(), "26b: the event's workflow ended before the event")
                t0 = time.perf_counter()
                req = urllib.request.Request(
                    f"{url}/api/workflow/events/{SURFACE_EVENT_KEY}", method="POST",
                    data=json.dumps({"source": "chip_smoke"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    check(json.loads(r.read())["ok"], "26b: the dashboard refused the event")
                got = fut.result(timeout=SURFACE_TIMEOUT_S)
                check(got == "chip_smoke", f"26b: the event's workflow returned {got!r}")
                event = (f"released by a POST to /api/workflow/events/{SURFACE_EVENT_KEY} in "
                         f"{time.perf_counter() - t0:.2f} s")
            print(f"workflow on {card}: make_batches -> train ({spec['model']} b{spec['batch']} "
                  f"s{spec['seq']}, {spec['steps']} steps, num_gpus={gpus}, on "
                  f"{result['card']}) -> summarize; the first run failed in summarize after "
                  f"{first_s:.1f} s, resume {resume_s:.2f} s ran summarize alone (runs {runs}); "
                  f"losses {[round(x, 4) for x in result['losses']]} against phase 5's "
                  f"{[round(x, 4) for x in in_process['losses']]} (largest relative "
                  f"{max(rel):.2e}, rtol {TRAINER_LOSS_RTOL}); launches {result['launches']}; "
                  f"event step {event}: ok", flush=True)

        if "c" in parts:
            # 26c. a thin client with no card driving the card
            address = rt.client_server_address()
            out_path = os.path.join(root, "client.pt")
            cspec = dict(spec, request=requests[0])
            env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
                   "PYTHONPATH": os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH"))
                                                 if p)}
            t0 = time.perf_counter()
            client = subprocess.run(
                [sys.executable, os.path.join(repo, "chip_smoke.py"), "--client-driver", address,
                 json.dumps(cspec), out_path], env=env, cwd=repo, capture_output=True, text=True,
                timeout=SURFACE_TIMEOUT_S)
            client_s = time.perf_counter() - t0
            lines = [line for line in client.stdout.splitlines()
                     if line.startswith(CLIENT_RESULT_TAG)]
            check(client.returncode == 0 and len(lines) == 1,
                  f"26c: the client exited {client.returncode}: {client.stdout[-3000:]}"
                  f"{client.stderr[-3000:]}")
            c = json.loads(lines[0][len(CLIENT_RESULT_TAG):])
            check(not c["client_sees_cuda"], "26c: the client process saw a CUDA card")
            got = torch.load(out_path)
            for name in ("task", "actor"):
                worst[f"client {name}"] = hold(f"26c {name}", got[name], requests[0], want[0])
                card_check(c[name]["card"] == card_name,
                           f"26c card: the client's {name} ran on {c[name]['card']!r}")
                card_check(c[name]["launches"] == {"flash_fwd": layers, "flash_bwd_dkv": 0,
                                                   "flash_bwd_dq": 0},
                           f"26c launches: the client's {name} launched {c[name]['launches']}")
            launches["client"] = {name: c[name]["launches"]["flash_fwd"] for name in ("task", "actor")}
            t0, state = time.perf_counter(), None
            while time.perf_counter() - t0 < 60:
                actor_states = [a["state"] for a in list_actors() if a.get("name") == CLIENT_ACTOR]
                held = [o for o in list_objects() if o.get("object_id") == c["held"]]
                state = (actor_states, len(held))
                if actor_states and all(s == "DEAD" for s in actor_states) and not held:
                    break
                time.sleep(0.5)
            else:
                check(False, f"26c: 60 s after the client left, its actor reads {state[0]} and "
                             f"{state[1]} of its objects remain")
            cleanup_s = time.perf_counter() - t0
            print(f"thin client on {card}: a process with CUDA_VISIBLE_DEVICES='' connected to "
                  f"{address.split('?')[0]} in {c['connect_s']:.2f} s; num_gpus={gpus} task: "
                  f"first call {c['task_first_s']:.2f} s (worker, model), next "
                  f"{c['task_s']:.2f} s; actor: first call {c['actor_first_s']:.2f} s, next "
                  f"{c['actor_s']:.3f} s; its host tensors within {SERVE_LOGITS_REL} of this "
                  f"process's forward (task {worst['client task']:.3e}, actor "
                  f"{worst['client actor']:.3e}); launches task {c['task']['launches']}, actor "
                  f"{c['actor']['launches']} on {c['task']['card']}; after it left, its actor "
                  f"dead and its object freed within {cleanup_s:.1f} s; client process "
                  f"{client_s:.1f} s: ok", flush=True)

        if "d" in parts:
            # 26d. a pip runtime_env on the card
            wheel = make_wheel(root, "rtpt_smoke_pkg", body="VALUE = 26\n")
            task = rt.remote(num_gpus=gpus)(pip_env_task)
            t0 = time.perf_counter()
            r = rt.get(task.options(runtime_env={"pip": [wheel]}).remote(spec),
                       timeout=SURFACE_TIMEOUT_S)
            pip_s = time.perf_counter() - t0
            cache = os.path.join(root, "runtime_env", "pip")
            check(r["value"] == 26 and r["pkg_file"].startswith(cache + os.sep),
                  f"26d: the wheel imported from {r['pkg_file']}, not the env under {cache}")
            check(not r["torch_file"].startswith(cache), f"26d: torch came from {r['torch_file']}")
            card_check(r["card"] == card_name,
                       f"26d card: the pip env's task ran on {r['card']!r}")
            card_check(r["launches"]["flash_fwd"] == 1,
                       f"26d launches: the pip env's task launched {r['launches']}")
            check(r["max_abs_err"] <= O_TOL, f"26d: K1 against its plain version {r['max_abs_err']:.3e}")
            absent = rt.get(rt.remote(num_gpus=0)(pip_absent_task).remote(), timeout=SURFACE_TIMEOUT_S)
            check(absent == "isolated", f"26d: a task without the env imported the wheel ({absent})")
            launches["pip"] = r["launches"]["flash_fwd"]
            print(f"pip runtime_env on {card}: a num_gpus={gpus} task in a venv built from a "
                  f"local wheel in {pip_s:.1f} s imports it ({r['pkg_file']}) and the system's "
                  f"torch, sees {r['card']} (CUDA_VISIBLE_DEVICES={r['visible']}), K1 at bh "
                  f"{PIP_ATTN['bh']} t {PIP_ATTN['t']} d {PIP_ATTN['d']} within "
                  f"{r['max_abs_err']:.3e} of its plain version, launches {r['launches']}; a "
                  f"task without the env cannot import it: ok", flush=True)
    finally:
        rt.shutdown()
        del model
        if on_card:
            torch.cuda.empty_cache()
        if saved_root is None:
            os.environ.pop("RAY_TPU_TORCH_TEMP_DIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TEMP_DIR"] = saved_root
        shutil.rmtree(root, ignore_errors=True)
    if skipped:
        print(f"phase 26 off the card: {len(skipped)} checks that need it skipped: {skipped}",
              flush=True)
    return {"launches": launches, "skipped": skipped}


def mesh_launches(axes, num_layers: int, dispatch: str, steps: int):
    """K1-K5 launches over the ranks of a Mixtral mesh in `steps` train
    steps under remat "dots": on every rank each layer's attention runs
    K1 in the forward and again in the recompute and K2 and K3 once per
    ring block (a seq group of n holds n(n + 1) / 2 blocks, future ones
    run nothing), and with "gmm" each rank runs K4 six times a layer in
    the forward and the recompute, three more in the dlhs form, and K5
    three times, whatever its share of the pairs."""
    ranks = math.prod(axes.values())
    seq = axes.get("seq", 1)
    blocks = ranks // seq * seq * (seq + 1) // 2
    gmm = dispatch == "gmm"
    per_step = {"flash_fwd": 2 * num_layers * blocks, "flash_bwd_dkv": num_layers * blocks,
                "flash_bwd_dq": num_layers * blocks,
                "gmm": 9 * num_layers * ranks if gmm else 0,
                "tgmm": 3 * num_layers * ranks if gmm else 0}
    return {name: n * steps for name, n in per_step.items()}


def mesh_spec(**over):
    """What phase 27a runs: mixtral-small on the card, b2 s2048, bf16
    parameters and compute. The CPU rehearsal
    (tests/test_torch_mesh_phase.py) overrides the model, the device, the
    sizes and the dtypes."""
    spec = {"model": "mixtral-small", "device": "cuda", "batch": BATCH, "seq": SEQ,
            "param_dtype": "bfloat16", "dtype": "bfloat16", "steps": MESH_TIMED_STEPS}
    spec.update(over)
    return spec


def phase_meshes(card, spec=None, backend="gloo", label="27a", single=None, ranks=None):
    """Phase 27a: each of MESH_CASES over 4 ranks in one world, against
    the same steps on one process with the same dispatch. Returns the
    launches over the ranks by case label; on the CPU (the rehearsal)
    the launch checks are left to the caller. Phase 30c runs it with
    `backend` "nccl" (a card per rank) and its `label`; `single` holds
    the one-process steps by (dispatch, dtype), filled where missing, so
    that 30c reuses 27a's; `ranks`, where given, takes each case's
    per-rank launches and expert all-reduce ms."""
    import numpy as np
    import torch
    from dataclasses import replace

    from ray_tpu_torch.models.mixtral import CONFIGS, MixtralForCausalLM, moe_lm_loss
    from ray_tpu_torch.parallel.launch import run_mixtral_trains, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    spec = spec or mesh_spec()
    device, steps = spec["device"], spec["steps"]

    def case_cfg(dispatch, dtype):
        """The config of a case: the spec's dtypes, or `dtype` for both."""
        return replace(CONFIGS[spec["model"]], moe_dispatch=dispatch,
                       param_dtype=getattr(torch, dtype or spec["param_dtype"]),
                       dtype=getattr(torch, dtype or spec["dtype"]))

    ids = np.random.RandomState(0).randint(0, CONFIGS[spec["model"]].vocab_size,
                                           (spec["batch"], spec["seq"]))
    single = {} if single is None else single
    for key in sorted({(d, dt or "") for _, _, d, dt in MESH_CASES} - set(single)):
        model = MixtralForCausalLM(case_cfg(*key), device=device)
        optimizer = make_optimizer(model)
        ids_d = torch.as_tensor(ids, dtype=torch.long, device=device)
        targets = torch.roll(ids_d, -1, 1)
        single[key] = timed_steps(
            lambda: train_step(model, optimizer, ids_d, targets, moe_lm_loss), steps)
        del model, optimizer
        if device == "cuda":
            torch.cuda.empty_cache()
    cases = [(MeshSpec(**axes), case_cfg(d, dt)) for _, axes, d, dt in MESH_CASES]
    t0 = time.perf_counter()
    res = spawn(run_mixtral_trains, 4, cases, ids, steps,
                *(("cpu",) if device == "cpu" else ()), deadline_s=600, backend=backend)
    seconds = time.perf_counter() - t0
    nccl = backend == "nccl"
    where = ("4 ranks on 4 cards over NCCL" if nccl
             else "4 ranks sharing the card over gloo through host memory")
    out = {}
    phase = label
    for i, (label, axes, dispatch, dtype) in enumerate(MESH_CASES):
        rs = [r[i] for r in res]
        cfg = cases[i][1]
        want, want_s = single[(dispatch, dtype or "")]
        losses = rs[0]["losses"]
        check(all(r["losses"] == losses for r in rs),
              f"{phase} {label}: ranks report different losses")
        check(all(math.isfinite(x) for x in losses), f"{phase} {label}: loss not finite: {losses}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        check(max(rel) <= RING_LOSS_RTOL,
              f"{phase} {label}: losses {losses} vs one process's {want}: relative {rel} "
              f"(rtol {RING_LOSS_RTOL})")
        check(losses[-1] < losses[0], f"{phase} {label}: loss did not fall: {losses}")
        for r in rs:
            same = [p["param_digest"] for p in rs if (p["expert_rank"], p["tensor_rank"])
                    == (r["expert_rank"], r["tensor_rank"])]
            check(all(d == r["param_digest"] for d in same),
                  f"{phase} {label}: ranks holding the same part of the model differ: {same}")
            check(r["replicated_digest"] == rs[0]["replicated_digest"],
                  f"{phase} {label}: the unsplit parameters differ between ranks")
        launches = {name: sum(r["launches"].get(name, 0) + r["gmm_launches"].get(name, 0)
                              for r in rs)
                    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "gmm", "tgmm")}
        expected = mesh_launches(axes, cfg.num_layers, dispatch, steps + 1)
        if device == "cuda":
            check(launches == expected,
                  f"{phase} {label}: launches over the ranks {launches}, expected {expected}")
            if dispatch == "gmm":
                for r in rs:
                    check(r["gmm_launches"]["gmm"] > 0 and r["gmm_launches"]["tgmm"] > 0,
                          f"{phase} {label}: a rank launched no K4 or K5: {r['gmm_launches']}")
        out[label] = launches
        ordered = sorted(rs, key=lambda r: (r["data_rank"], r["seq_rank"], r["expert_rank"],
                                            r["tensor_rank"]))
        reduce_ms = [r["spans"].get("moe_all_reduce", {}).get("ms", 0.0) for r in ordered]
        if ranks is not None:
            ranks[label] = {"launches": [{**r["launches"], **r["gmm_launches"]} for r in ordered],
                            "moe_all_reduce_ms": reduce_ms,
                            "step_ms": [r["step_ms"] for r in ordered]}
        for r, ms in zip(ordered, reduce_ms):
            peak = r["peak_memory_gb"]
            print(f"{phase} {label}: rank data {r['data_rank']} seq {r['seq_rank']} expert "
                  f"{r['expert_rank']} tensor {r['tensor_rank']}: backend {r['backend']}, "
                  f"{r['device']} ({r['card']}), step {r['step_ms']:.1f} ms, expert all-reduces "
                  f"{ms:.2f} ms of the last step, peak memory "
                  f"{'n/a' if peak is None else f'{peak:.2f} GB'}"
                  f"{'' if nccl else ' (host-staged)'}", flush=True)
        axes_s = " x ".join(f"{a} {n}" for a, n in axes.items())
        print(f"{phase} {spec['model']} on {axes_s} ({dispatch}, b{spec['batch']} s{spec['seq']}, "
              f"{dtype or spec['param_dtype']} parameters, {dtype or spec['dtype']} compute, "
              f"remat dots) on {card}, {where}: "
              f"losses {losses} against one process's in the same dtypes "
              f"{want} (relative {max(rel):.2e}, rtol {RING_LOSS_RTOL}), equal parts, step "
              f"{max(r['step_ms'] for r in rs):.1f} ms (slowest rank; one process "
              f"{want_s / steps * 1e3:.1f} ms), launches over the ranks {launches} (expected "
              f"{expected}): ok"
              f"{'' if nccl else '; not a measure of scaling (one card, host-staged exchange)'}",
              flush=True)
    print(f"{phase}: world of 4 ranks, {len(MESH_CASES)} meshes, in {seconds:.1f} s; the tensor "
          "axis runs in float32 on the mesh and on one card because in bf16 a router "
          "near-tie, not the split, decides the 1e-3 comparison", flush=True)
    return out


class CClientLlama:
    """27b's actor: the model on the card, answering a prompt's int32 ids
    (bytes) with the greedy next token (int32) and the last row's float32
    logits, as bytes for a C caller."""

    def __init__(self, spec):
        self.spec = spec
        self.model = surface_model(spec)

    def next_token(self, ids):
        import struct

        import numpy as np

        logits = surface_logits(self.model, np.frombuffer(ids, np.int32).tolist(),
                                self.spec["device"]).cpu()
        return struct.pack("<i", int(logits.argmax())) + logits.numpy().tobytes()

    def reset(self):
        from ray_tpu_torch.ops import attention as A

        A.reset_launch_counts()

    def stats(self):
        return surface_worker_stats()


def phase_c_client(card, spec=None):
    """Phase 27b: the port's C client driver against a one-GPU actor
    holding the model, held bitwise against this process's forward; then
    27c, the native store and codec. Returns the actor's K1-K3 launches
    over the C calls. With a spec whose device is the CPU (the
    rehearsal), the card's checks are listed, not made; returns them too."""
    import struct
    import subprocess

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import fastpath, native_store, native_tools
    from ray_tpu_torch._private.worker import global_client
    from ray_tpu_torch.models.llama import CONFIGS

    spec = spec or surface_spec()
    device = spec["device"]
    on_card = device == "cuda"
    skipped = []

    def card_check(ok, what):
        if on_card:
            check(ok, what)
        else:
            skipped.append(what.split(":")[0])

    t0 = time.perf_counter()
    driver = native_tools.build("rtpt_client_test")
    library = native_tools.build("librtpt_client.so")
    build_s = time.perf_counter() - t0
    layers = CONFIGS[spec["model"]].num_layers
    prompt = np.random.RandomState(2).randint(
        0, CONFIGS[spec["model"]].vocab_size, C_PROMPT_LEN).astype(np.int32)
    model = surface_model(spec)
    want = surface_logits(model, prompt.tolist(), device).cpu()
    here_ms = []
    for _ in range(C_CALLS):
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        surface_logits(model, prompt.tolist(), device).cpu()
        here_ms.append((time.perf_counter() - t1) * 1e3)
    del model
    want_bytes = struct.pack("<i", int(want.argmax())) + want.numpy().tobytes()
    # The reply carries the logits inline: raise the inline limit past
    # their size for this phase's runtime (its workers inherit it).
    key = "RAY_TPU_TORCH_max_inline_object_size"
    saved = os.environ.get(key)
    os.environ[key] = str(2 * len(want_bytes))
    work = tempfile.mkdtemp(prefix="rtpt")
    rt.init(**({} if on_card else {"num_cpus": 2}))
    try:
        actor = rt.remote(num_gpus=1 if on_card else 0)(CClientLlama).remote(spec)
        seen = rt.get(actor.stats.remote(), timeout=SURFACE_TIMEOUT_S)
        card_check(seen["card"] == torch.cuda.get_device_name(0) if on_card else True,
                   f"27b: the actor sees {seen['card']}")
        rt.get(actor.next_token.remote(prompt.tobytes()), timeout=SURFACE_TIMEOUT_S)  # warm
        rt.get(actor.reset.remote(), timeout=SURFACE_TIMEOUT_S)
        client = global_client()
        aid = actor._actor_id.binary()
        addr = None
        deadline = time.time() + 60
        while addr is None and time.time() < deadline:
            addr = client.request({"type": "get_actor_direct", "actor_id": aid}).get("addr")
            if addr is None:
                time.sleep(0.1)
        check(addr is not None, "27b: the actor's direct socket was not published")
        arg, out_path = os.path.join(work, "prompt.bin"), os.path.join(work, "reply.bin")
        with open(arg, "wb") as f:
            f.write(prompt.tobytes())
        proc = subprocess.run([driver, addr, client._authkey.hex(), aid.hex(), "call",
                               "next_token", arg, out_path, str(C_CALLS)],
                              capture_output=True, text=True, timeout=SURFACE_TIMEOUT_S)
        check(proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "ok",
              f"27b: the C driver failed ({proc.returncode}): {proc.stdout[-500:]} "
              f"{proc.stderr[-500:]}")
        call_ms = [float(line.split()[1]) for line in proc.stdout.splitlines()
                   if line.startswith("call_ms ")]
        with open(out_path, "rb") as f:
            got = f.read()
        stats = rt.get(actor.stats.remote(), timeout=SURFACE_TIMEOUT_S)
    finally:
        rt.shutdown()
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved
    check(len(call_ms) == C_CALLS, f"27b: {len(call_ms)} timed calls, expected {C_CALLS}")
    token = struct.unpack("<i", got[:4])[0]
    check(got == want_bytes,
          f"27b: the C caller's reply ({len(got)} bytes, next token {token}) is not this "
          f"process's forward bitwise ({len(want_bytes)} bytes, next token "
          f"{int(want.argmax())}); logits max difference "
          f"{float((torch.frombuffer(bytearray(got[4:]), dtype=torch.float32) - want).abs().max()) if len(got) == len(want_bytes) else 'n/a'}")
    launches = stats["launches"]
    card_check(launches.get("flash_fwd") == layers * C_CALLS
               and not launches.get("flash_bwd_dkv") and not launches.get("flash_bwd_dq"),
               f"27b: the actor launched {launches} over {C_CALLS} C calls, expected K1 "
               f"{layers * C_CALLS} and no K2 or K3")
    print(f"27b: the C client ({os.path.relpath(driver)}, {os.path.relpath(library)}, built "
          f"in {build_s:.1f} s) called a num_gpus=1 {spec['model']} actor on {card} over "
          f"{addr}: a prompt of {C_PROMPT_LEN} int32 ids in, next token {token} and "
          f"{len(got) - 4} bytes of float32 logits out, bitwise this process's forward; ms "
          f"per call {float(np.median(call_ms)):.2f} median ({min(call_ms):.2f}-"
          f"{max(call_ms):.2f}, first {call_ms[0]:.2f}), this process's forward "
          f"{float(np.median(here_ms)):.2f} median; K1 {launches.get('flash_fwd')} in the "
          f"actor over {C_CALLS} calls: ok", flush=True)
    # 27c. the runtime's native store and codec, built from the port's sources
    csrc = os.path.join(os.path.dirname(os.path.abspath(native_store.__file__)), "csrc")
    for name, src in (("native_store", native_store._SRC), ("fastpath", fastpath._SRC)):
        check(os.path.dirname(os.path.abspath(src)) == csrc,
              f"27c: {name} builds from {src}, not from {csrc}")
    check(native_store.native_available(),
          f"27c: the native object store did not build: {native_store.build_error}")
    check(fastpath.available(), f"27c: the fastpath codec did not build: {fastpath.build_error}")
    print(f"27c: the native object store ({os.path.relpath(native_store._LIB_PATH)}) and the "
          f"fastpath codec ({os.path.relpath(fastpath._MOD_PATH)}) built from "
          f"{os.path.relpath(csrc)} and live: ok", flush=True)
    return {"launches": launches, "skipped": skipped}


class FaultLlama:
    """28a's actor: the model built from weights that reach it through the
    object store (the ref in the constructor's argument, read again when
    the actor restarts); answers a request with its last position's
    logits, float32 on the host. `stats` gives the wall clock at the
    constructor's start and the seconds of its get, build and load."""

    def __init__(self, spec, weights_refs):
        import ray_tpu_torch as rt
        from ray_tpu_torch.ops import attention as A

        started = time.time()
        self.spec = spec
        t0 = time.perf_counter()
        weights = rt.get(weights_refs[0], timeout=FAULT_TIMEOUT_S)
        t1 = time.perf_counter()
        self.model = surface_model(spec)
        t2 = time.perf_counter()
        self.model.load_state_dict(weights)
        if spec["device"] == "cuda":
            import torch

            torch.cuda.synchronize()
        self.times = {"started": started, "get_s": t1 - t0, "build_s": t2 - t1,
                      "load_s": time.perf_counter() - t2}
        A.reset_launch_counts()

    def answer(self, ids):
        return surface_logits(self.model, ids, self.spec["device"]).cpu()

    def stats(self):
        import os

        from ray_tpu_torch._private import chaos, lock_witness

        faults = chaos.active()
        return {"pid": os.getpid(), "witness": lock_witness.installed(),
                "chaos": None if faults is None else dict(faults.stats), **self.times,
                **surface_worker_stats()}


def fault_train_task(spec, attempts_dir):
    """28b's task: phase 5's model, seed and batch, FAULT_STEPS train
    steps, K1-K3 counted here. An attempt's index is the number of
    attempts before it (a file each in `attempts_dir`); after each step it
    passes the kill point FAULT_KILL_POINT.attempt<a>.step<s>, where the
    phase's chaos rule kills the first attempt after its first step."""
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos, lock_witness
    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.ops import attention as A

    attempt = len(os.listdir(attempts_dir))
    with open(os.path.join(attempts_dir, f"attempt{attempt}"), "w") as f:
        f.write(f"{os.getpid()} {time.time()}\n")
    model = surface_model(spec)
    optimizer = train.make_optimizer(model)
    vocab = CONFIGS[spec["model"]].vocab_size
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, vocab, (spec["batch"], spec["seq"])),
                          dtype=torch.long, device=spec["device"])
    targets = torch.roll(ids, -1, dims=1)
    A.reset_launch_counts()
    losses = []
    for step in range(1, FAULT_STEPS + 1):
        losses.append(float(train.train_step(model, optimizer, ids, targets)))
        chaos.kill_point(f"{FAULT_KILL_POINT}.attempt{attempt}.step{step}")
    faults = chaos.active()
    return {"attempt": attempt, "pid": os.getpid(), "losses": losses, "ended": time.time(),
            "witness": lock_witness.installed(),
            "chaos": None if faults is None else dict(faults.stats), **surface_worker_stats()}


def phase_faults(card, in_process, spec=None):
    """Phase 28: the runtime under faults, on a runtime of the phase's own
    under a temp root of its own, with FAULT_SPEC installed (seed
    FAULT_SEED) in every process of it and the lock witness armed in every
    process, all appending to one sidecar file. 28a: a num_gpus=1,
    max_restarts=1 actor holding the model (its weights put by this
    process) answers phase 23's requests; its worker is SIGKILLed after
    FAULT_KILL_AFTER answers, and the restarted actor, in a new process on
    the card, answers the rest; every row within SERVE_LOGITS_REL of this
    process's forward, K1 counted in each incarnation. 28b: a num_gpus=1,
    max_retries=1 task of FAULT_STEPS train steps whose first attempt the
    chaos rule kills after its first step; the retry's losses are phase
    5's first (`in_process`), bitwise. 28c: no lock-order inversion in any
    process. With a spec whose device is the CPU (the rehearsal), the card
    checks are listed, not made. Returns K1-K3's launches in the phase's
    workers, the skipped checks and the readings."""
    import shutil
    import signal

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import chaos, lock_witness
    from ray_tpu_torch._private.config import RayConfig
    from ray_tpu_torch.exceptions import RayActorError
    from ray_tpu_torch.models.llama import CONFIGS

    t_phase = time.perf_counter()
    spec = spec or surface_spec()
    device = spec["device"]
    on_card = device == "cuda"
    card_name = torch.cuda.get_device_name(0) if on_card else None
    layers = CONFIGS[spec["model"]].num_layers
    vocab = CONFIGS[spec["model"]].vocab_size
    kill_after = spec["requests"] // 2
    skipped = []

    def card_check(ok, what):
        if on_card:
            check(ok, what)
        else:
            skipped.append(what.split(":")[0])

    lengths = np.random.RandomState(0).randint(spec["min_len"], spec["max_len"] + 1,
                                               spec["requests"])
    ids_rng = np.random.RandomState(1)
    requests = [ids_rng.randint(0, vocab, n).tolist() for n in lengths]
    # The oracle, and the weights the actor is built from.
    model = surface_model(spec)
    want = [surface_logits(model, r, device).cpu() for r in requests]
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    weights_gb = sum(v.numel() * v.element_size() for v in weights.values()) / 1e9
    del model
    if on_card:
        torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="rtpt")
    attempts_dir = os.path.join(root, "attempts")
    os.mkdir(attempts_dir)
    sidecar = os.path.join(root, "lock_witness.log")
    spec_text = f"{FAULT_SPEC},{FAULT_KILL_RULE}"
    env = {"RAY_TPU_TORCH_TEMP_DIR": root, "RAY_TPU_TORCH_chaos_spec": spec_text,
           "RAY_TPU_TORCH_chaos_seed": str(FAULT_SEED), lock_witness.ENV_VAR: "1",
           lock_witness.FILE_ENV: sidecar}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    was_witnessed = lock_witness.installed()
    lock_witness.install()
    print(f"phase 28: chaos seed {FAULT_SEED}, spec {spec_text}", flush=True)
    answers, readings = [], {}
    init_kw = {} if spec["num_cpus"] is None else {"num_cpus": spec["num_cpus"]}
    try:
        rt.init(_system_config={"chaos_spec": spec_text, "chaos_seed": FAULT_SEED}, **init_kw)
        check(chaos.active() is not None, "phase 28: no chaos schedule in the driver")
        # The actor and the task ask for a GPU wherever the runtime has
        # one: the card, or the CPU rehearsal's RAY_TPU_TORCH_NUM_GPUS.
        gpus = 1 if rt.cluster_resources().get("GPU", 0) >= 1 else 0
        check(gpus == 1 or not on_card, "phase 28: the runtime detected no GPU")
        try:
            # 28a. an actor restart on the card
            t0 = time.perf_counter()
            weights_ref = rt.put(weights)
            put_s = time.perf_counter() - t0
            del weights
            submitted = time.time()
            actor = rt.remote(num_gpus=gpus, max_restarts=1)(FaultLlama).remote(
                spec, [weights_ref])
            first = rt.get(actor.stats.remote(), timeout=FAULT_TIMEOUT_S)
            ready_s = time.time() - submitted
            for r in requests[:kill_after]:
                answers.append(rt.get(actor.answer.remote(r), timeout=FAULT_TIMEOUT_S))
            before = rt.get(actor.stats.remote(), timeout=FAULT_TIMEOUT_S)
            os.kill(before["pid"], signal.SIGKILL)
            killed = time.time()
            t_kill = time.perf_counter()
            restart_s, failed_calls = None, 0
            for r in requests[kill_after:]:
                deadline = time.perf_counter() + FAULT_TIMEOUT_S
                while True:
                    try:
                        answers.append(rt.get(actor.answer.remote(r), timeout=FAULT_TIMEOUT_S))
                        break
                    except RayActorError:
                        failed_calls += 1
                        check(time.perf_counter() < deadline,
                              "28a: the actor did not come back after its worker was killed")
                        time.sleep(0.2)
                if restart_s is None:
                    restart_s = time.perf_counter() - t_kill
            after = rt.get(actor.stats.remote(), timeout=FAULT_TIMEOUT_S)
            rt.kill(actor)
            del weights_ref
            worst = 0.0
            for i, (r, got, want_row) in enumerate(zip(requests, answers, want)):
                got = torch.as_tensor(got)
                rel = float((got - want_row).norm() / want_row.norm())
                worst = max(worst, rel)
                check(bool(torch.isfinite(got).all()) and got.shape == want_row.shape
                      and rel <= SERVE_LOGITS_REL,
                      f"28a: request {i} of {len(r)} tokens: logits relative error {rel:.3e}")
            check(len(answers) == len(requests),
                  f"28a: {len(answers)} answers to {len(requests)} requests")
            check(after["pid"] != before["pid"],
                  f"28a: the actor answers from pid {after['pid']} after its worker "
                  f"{before['pid']} was killed")
            check(before["witness"] and after["witness"],
                  "28a: the lock witness is not armed in the actor's worker")
            check(before["chaos"] is not None and after["chaos"] is not None,
                  "28a: the chaos schedule is not installed in the actor's worker")
            for label, seen in (("first", before), ("restarted", after)):
                card_check(seen["card"] == card_name,
                           f"28a card: the {label} actor ran on {seen['card']!r}")
            k1_before = before["launches"].get("flash_fwd", 0)
            k1_after = after["launches"].get("flash_fwd", 0)
            card_check(k1_before == layers * kill_after > 0
                       and k1_after == layers * (len(requests) - kill_after) > 0,
                       f"28a launches: K1 launched {k1_before} times before the restart and "
                       f"{k1_after} after, expected {layers} per answer, "
                       f"{kill_after} and {len(requests) - kill_after} answers")
            def start(seen, since):
                return (f"{seen['started'] - since:.2f} s to the constructor, get "
                        f"{seen['get_s']:.2f} s, build {seen['build_s']:.2f} s, load "
                        f"{seen['load_s']:.2f} s")

            print(f"28a: a num_gpus=1 max_restarts=1 {spec['model']} actor on {card} from "
                  f"{weights_gb:.2f} GB of weights put in {put_s:.2f} s, "
                  f"ready in {ready_s:.2f} s ({start(first, submitted)}; pid {first['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={first['visible']}); its worker SIGKILLed after "
                  f"{kill_after} answers; restarted in a new pid {after['pid']} and answered "
                  f"{restart_s:.2f} s after the kill ({start(after, killed)}; {failed_calls} "
                  f"calls refused meanwhile); {len(answers)} rows "
                  f"within {SERVE_LOGITS_REL} of this process's forward (worst {worst:.3e}); "
                  f"K1 {k1_before} before the restart and {k1_after} after; faults injected "
                  f"in the actor's workers {before['chaos']}, {after['chaos']}: ok", flush=True)
            readings.update(put_s=put_s, ready_s=ready_s, restart_s=restart_s,
                            refused_calls=failed_calls, worst_rel=worst,
                            restart_to_constructor_s=after["started"] - killed,
                            restart_get_s=after["get_s"], restart_build_s=after["build_s"],
                            restart_load_s=after["load_s"])

            # 28b. a task retry on the card
            task = rt.remote(num_gpus=gpus, max_retries=1)(fault_train_task)
            submitted = time.time()
            out = rt.get(task.remote(spec, attempts_dir), timeout=FAULT_TIMEOUT_S)
            retry_s = time.time() - submitted
            attempts = sorted(os.listdir(attempts_dir))
            check(attempts == ["attempt0", "attempt1"] and out["attempt"] == 1,
                  f"28b: attempts {attempts}, the result from attempt {out['attempt']}, "
                  f"expected the retry of one killed attempt")
            with open(os.path.join(attempts_dir, "attempt0")) as f:
                first_pid, first_started = f.read().split()
            with open(os.path.join(attempts_dir, "attempt1")) as f:
                retry_started = float(f.read().split()[1])
            first_pid = int(first_pid)
            first_started = float(first_started)
            check(first_pid != out["pid"], f"28b: the retry ran in the killed pid {first_pid}")
            want_losses = in_process["losses"][:FAULT_STEPS]
            check(out["losses"] == want_losses,
                  f"28b: the retry's losses {out['losses']} are not phase 5's first "
                  f"{FAULT_STEPS} {want_losses} bitwise")
            check(out["witness"], "28b: the lock witness is not armed in the task's worker")
            check(out["chaos"] is not None,
                  "28b: the chaos schedule is not installed in the task's worker")
            card_check(out["card"] == card_name, f"28b card: the retry ran on {out['card']!r}")
            per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
            card_check(out["launches"] == {k: v * FAULT_STEPS for k, v in per_step.items()},
                       f"28b launches: the retry launched {out['launches']} in {FAULT_STEPS} "
                       f"steps, expected {per_step} per step")
            print(f"28b: a num_gpus=1 max_retries=1 task on {card}: attempt 0 (pid {first_pid}) "
                  f"killed by the chaos rule after step 1, the retry (pid {out['pid']}, "
                  f"CUDA_VISIBLE_DEVICES={out['visible']}) took {FAULT_STEPS} steps, losses "
                  f"{out['losses']} bitwise phase 5's first {FAULT_STEPS}, {retry_s:.2f} s from "
                  f"submit to result (attempt 0 started {first_started - submitted:.2f} s after "
                  f"submit, the retry {retry_started - first_started:.2f} s after attempt 0, "
                  f"its steps done {out['ended'] - retry_started:.2f} s after that); "
                  f"launches {out['launches']}; faults injected in the "
                  f"retry's worker {out['chaos']}: ok", flush=True)
            readings.update(retry_s=retry_s, retry_losses=out["losses"],
                            first_attempt_start_s=first_started - submitted,
                            retry_start_s=retry_started - first_started,
                            retry_steps_s=out["ended"] - retry_started)
            stats = dict(chaos.active().stats)
        finally:
            rt.shutdown()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        RayConfig._values["chaos_spec"] = ""
        chaos.install("", 0)
        driver_violations = [v.render() for v in lock_witness.violations()]
        report = lock_witness.witness_report()
        if not was_witnessed:
            lock_witness.uninstall()
    # 28c. the lock witness, in every process of 28a-b
    side = ""
    if os.path.exists(sidecar):  # a process writes it at its first inversion
        with open(sidecar, encoding="utf-8") as f:
            side = f.read()
    shutil.rmtree(root, ignore_errors=True)
    inversions = side.count("lock-order inversion")
    check(inversions == 0 and not driver_violations,
          f"28c: {inversions} lock-order inversions witnessed in the phase's processes, "
          f"{len(driver_violations)} in this one:\n{side[:4000]}")
    check(report["edges"] > 0, f"28c: the witness saw no lock order in this process: {report}")
    print(f"28c: the lock witness armed in every process of 28a-b: 0 lock-order inversions "
          f"(this process {report['edges']} lock-order edges over {report['sites']} sites); "
          f"chaos faults injected in this process {stats}: ok", flush=True)
    launches = {"flash_fwd": k1_before + k1_after + out["launches"].get("flash_fwd", 0),
                "flash_bwd_dkv": out["launches"].get("flash_bwd_dkv", 0),
                "flash_bwd_dq": out["launches"].get("flash_bwd_dq", 0)}
    phase_s = time.perf_counter() - t_phase
    readings["phase_s"] = phase_s
    print(f"phase 28 on {card}: {phase_s:.1f} s; K1-K3 launches in its workers {launches}",
          flush=True)
    return {"launches": launches, "skipped": skipped, "readings": readings}


class ObservedLlama:
    """Phase 29's actor: phase 5's model, seed and batch, built as 28b's
    task builds them, K1-K3 counted from its first step. `train_stream`
    (the "compute" group) takes the train steps and yields each step's
    loss as it finishes; after the first it holds until `release` (the
    "io" group) is called, or OBSERVED_TIMEOUT_S passes, so the driver
    reads the actor while its stream runs. `probe` (the "io" group) gives
    the steps taken and K1's launches so far. Each step adds one to the
    user counter OBSERVED_COUNTER."""

    def __init__(self, spec):
        import threading

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models.llama import CONFIGS
        from ray_tpu_torch.ops import attention as A
        from ray_tpu_torch.util.metrics import Counter

        started = time.time()
        t0 = time.perf_counter()
        self.model = surface_model(spec)
        self.optimizer = train.make_optimizer(self.model)
        vocab = CONFIGS[spec["model"]].vocab_size
        self.ids = torch.as_tensor(
            np.random.RandomState(0).randint(0, vocab, (spec["batch"], spec["seq"])),
            dtype=torch.long, device=spec["device"])
        self.targets = torch.roll(self.ids, -1, dims=1)
        self.steps = 0
        self.released = threading.Event()
        self.counter = Counter(OBSERVED_COUNTER, description="phase 29's train steps")
        self.times = {"started": started, "build_s": time.perf_counter() - t0}
        A.reset_launch_counts()

    def train_stream(self, steps):
        from ray_tpu_torch import train

        for step in range(1, steps + 1):
            t0 = time.perf_counter()
            loss = float(train.train_step(self.model, self.optimizer, self.ids, self.targets))
            self.steps = step
            self.counter.inc(1.0)
            yield {"step": step, "loss": loss, "step_s": time.perf_counter() - t0,
                   "at": time.time()}
            if step == 1:
                self.released.wait(OBSERVED_TIMEOUT_S)

    def probe(self):
        from ray_tpu_torch.ops import attention as A

        return {"steps": self.steps, "k1": A.LAUNCHES.get("flash_fwd", 0), "at": time.time()}

    def release(self):
        self.released.set()
        return self.steps

    def stats(self):
        import os

        return {"pid": os.getpid(), **self.times, **surface_worker_stats()}


def observed_outside_task():
    """29c's task outside the group: it must never run."""
    return "ran"


def phase_observed(card, in_process, spec=None):
    """Phase 29: a GPU actor observed through the runtime's own
    instruments, on a runtime of the phase's own under a temp root of its
    own, with the dashboard up. A STRICT_PACK placement group of one
    {"GPU": 1, "CPU": 1} bundle holds the card (29c): while it lives the
    runtime shows no free GPU, and a num_gpus=1 task outside it stays
    pending and is cancelled. In it, a num_gpus=1 ObservedLlama actor with
    OBSERVED_GROUPS streams OBSERVED_STEPS train steps from its "compute"
    group (29a): the first loss reaches this process before the stream
    ends, and the losses are phase 5's first (`in_process`), bitwise.
    While the stream holds after its first step, OBSERVED_IO_CALLS calls
    of the "io" group answer with the steps taken (29b), and the worker's
    stack profile names the generator (29d). After the stream, 29d reads
    what the runtime recorded: the stream call's seven transitions and
    six timeline phases, and /metrics with the core series, the flight
    recorder's drop counter and the actor's counter at OBSERVED_STEPS. The
    group's removal frees the card (29c). With a spec whose device is the
    CPU (the rehearsal), the card checks are listed, not made. Returns
    K1-K3's launches in the actor, the skipped checks and the readings."""
    import shutil
    import socket
    import urllib.request

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.events import TASK_PHASES, TASK_TRANSITIONS
    from ray_tpu_torch._private.state import task_transitions, timeline
    from ray_tpu_torch._private.worker import global_client
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.exceptions import TaskCancelledError
    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy
    from ray_tpu_torch.util.state import list_workers

    t_phase = time.perf_counter()
    spec = spec or surface_spec()
    on_card = spec["device"] == "cuda"
    card_name = torch.cuda.get_device_name(0) if on_card else None
    layers = CONFIGS[spec["model"]].num_layers
    skipped = []

    def card_check(ok, what):
        if on_card:
            check(ok, what)
        else:
            skipped.append(what.split(":")[0])

    def io(method):
        return method.options(concurrency_group="io").remote()

    def wait_for(read, ok, what):
        deadline = time.perf_counter() + OBSERVED_TIMEOUT_S
        while True:
            value = read()
            if ok(value):
                return value
            check(time.perf_counter() < deadline, f"{what}: {value}")
            time.sleep(0.25)

    root = tempfile.mkdtemp(prefix="rtpt")
    saved_root = os.environ.get("RAY_TPU_TORCH_TEMP_DIR")
    os.environ["RAY_TPU_TORCH_TEMP_DIR"] = root
    init_kw = {} if spec["num_cpus"] is None else {"num_cpus": spec["num_cpus"]}
    readings = {}
    try:
        rt.init(**init_kw)
        try:
            check(rt.cluster_resources().get("GPU", 0) >= 1,
                  "phase 29: the runtime detected no GPU")
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            url = start_dashboard(port=port)

            # 29c. the placement group holds the card
            pg = placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
            check(pg.wait(timeout_seconds=OBSERVED_TIMEOUT_S),
                  "29c: the placement group was never placed")
            free_held = rt.available_resources().get("GPU", 0.0)
            check(free_held == 0, f"29c: {free_held} GPU free while the group holds the card")
            submitted = time.perf_counter()
            actor = rt.remote(num_gpus=1, num_cpus=1, concurrency_groups=OBSERVED_GROUPS)(
                ObservedLlama).options(
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=0)).remote(spec)
            first_stats = rt.get(io(actor.stats), timeout=OBSERVED_TIMEOUT_S)
            ready_s = time.perf_counter() - submitted
            outside = rt.remote(num_gpus=1)(observed_outside_task).remote()
            ran, _ = rt.wait([outside], timeout=OBSERVED_PENDING_S)
            check(not ran, "29c: a num_gpus=1 task outside the group ran while the group "
                           "held the card")
            check(rt.cancel(outside), "29c: the pending task outside the group was not "
                                      "cancelled")
            try:
                got = rt.get(outside, timeout=OBSERVED_TIMEOUT_S)
                check(False, f"29c: the cancelled task returned {got!r}")
            except TaskCancelledError:
                pass

            # 29a. the stream, and 29b. the io group while it runs
            t0 = time.perf_counter()
            stream = actor.train_stream.options(
                concurrency_group="compute", num_returns="streaming").remote(OBSERVED_STEPS)
            items = iter(stream)
            first = rt.get(next(items), timeout=OBSERVED_TIMEOUT_S)
            first_s = time.perf_counter() - t0
            probes = []
            for _ in range(OBSERVED_IO_CALLS):
                t1 = time.perf_counter()
                probe = rt.get(io(actor.probe), timeout=OBSERVED_TIMEOUT_S)
                probes.append(dict(probe, ms=(time.perf_counter() - t1) * 1e3))
            # 29d. the worker's stack while the generator runs
            wid = next(w["worker_id"] for w in list_workers(limit=1000)
                       if w["pid"] == first_stats["pid"])
            t1 = time.perf_counter()
            stack = global_client().request(
                {"type": "worker_stacks", "worker_id": bytes.fromhex(wid)},
                timeout=OBSERVED_TIMEOUT_S)
            stack_ms = (time.perf_counter() - t1) * 1e3
            check(stack.get("ok") and "train_stream" in stack.get("text", ""),
                  f"29d: the actor worker's stack does not name the generator: "
                  f"{str(stack)[:2000]}")
            rt.get(io(actor.release), timeout=OBSERVED_TIMEOUT_S)
            rest = [rt.get(ref, timeout=OBSERVED_TIMEOUT_S) for ref in items]
            end_s = time.perf_counter() - t0
            steps = [first] + rest
            losses = [x["loss"] for x in steps]
            want = in_process["losses"][:OBSERVED_STEPS]
            check([x["step"] for x in steps] == list(range(1, OBSERVED_STEPS + 1)),
                  f"29a: the stream yielded steps {[x['step'] for x in steps]}")
            check(losses == want, f"29a: the streamed losses {losses} are not phase 5's "
                                  f"first {OBSERVED_STEPS} {want} bitwise")
            check(first_s < end_s and first["at"] < steps[-1]["at"],
                  f"29a: the first loss came {first_s:.3f} s after the call, the stream "
                  f"ended {end_s:.3f} s after it")
            for i, probe in enumerate(probes):
                check(probe["steps"] < OBSERVED_STEPS and probe["at"] < steps[-1]["at"],
                      f"29b: io call {i} read {probe['steps']} steps at {probe['at']}, the "
                      f"stream's last step at {steps[-1]['at']}")
            after = rt.get(io(actor.stats), timeout=OBSERVED_TIMEOUT_S)
            for label, seen in (("constructor", first_stats), ("stream", after)):
                card_check(seen["card"] == card_name,
                           f"29a card: the actor's {label} ran on {seen['card']!r}")
            per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers,
                        "flash_bwd_dq": layers}
            launches = {k: after["launches"].get(k, 0) for k in per_step}
            card_check(launches == {k: v * OBSERVED_STEPS for k, v in per_step.items()},
                       f"29a launches: the actor launched {launches} in {OBSERVED_STEPS} "
                       f"steps, expected {per_step} per step")
            card_check(all(p["k1"] == 2 * layers for p in probes),
                       f"29b launches: the io calls read K1 at {[p['k1'] for p in probes]}, "
                       f"expected {2 * layers} after one step")
            print(f"29a: a num_gpus=1 {spec['model']} actor with concurrency groups "
                  f"{OBSERVED_GROUPS} in a STRICT_PACK group on {card}, ready in "
                  f"{ready_s:.2f} s (built in {first_stats['build_s']:.2f} s; pid "
                  f"{first_stats['pid']}, CUDA_VISIBLE_DEVICES={first_stats['visible']}); "
                  f"its stream's first loss {first_s:.3f} s after the call, the stream's end "
                  f"{end_s:.3f} s after it (held after step 1 until released); steps "
                  f"{[round(x['step_s'], 4) for x in steps]} s; losses {losses} bitwise "
                  f"phase 5's first {OBSERVED_STEPS}; launches {launches}: ok", flush=True)
            print(f"29b: {OBSERVED_IO_CALLS} io-group calls while the compute group's stream "
                  f"ran read steps {[p['steps'] for p in probes]} and K1 "
                  f"{[p['k1'] for p in probes]}, in {[round(p['ms'], 2) for p in probes]} ms: "
                  f"ok", flush=True)

            # 29d. what the runtime recorded
            tid = stream._task_id.hex()
            seen = wait_for(lambda: [e["event"] for e in task_transitions(tid)],
                            lambda names: set(TASK_TRANSITIONS) <= set(names),
                            "29d: the stream call's transitions")
            rows = [r for r in timeline() if r.get("cat") == "task_phase"
                    and r["args"]["task_id"] == tid]
            check([r["name"] for r in rows] == list(TASK_PHASES)
                  and all(r["dur"] >= 0 for r in rows)
                  # Contiguous, to a microsecond (ts and dur are in us).
                  and all(abs(b["ts"] - (a["ts"] + a["dur"])) <= 1.0
                          for a, b in zip(rows, rows[1:])),
                  f"29d: the stream call's timeline rows {rows}")
            phases_ms = {r["name"]: r["dur"] / 1e3 for r in rows}

            def scrape():
                with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
                    return r.read().decode()

            def counted(text):
                return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith(OBSERVED_COUNTER)
                           and line[len(OBSERVED_COUNTER)] in " {")

            text = wait_for(scrape, lambda s: counted(s) >= OBSERVED_STEPS,
                            "29d: /metrics never counted the actor's steps")
            check(counted(text) == OBSERVED_STEPS,
                  f"29d: /metrics counts {counted(text)} steps, expected {OBSERVED_STEPS}")
            core = ("ray_tpu_torch_resources_total", "ray_tpu_torch_nodes_alive",
                    "ray_tpu_torch_control_messages",
                    "ray_tpu_torch_flight_recorder_dropped_total")
            missing = [name for name in core if f"# TYPE {name} " not in text]
            check(not missing, f"29d: /metrics lacks {missing}")
            print(f"29d: the stream call's transitions {seen}; its timeline phases "
                  f"{ {k: round(v, 3) for k, v in phases_ms.items()} } ms; the worker's "
                  f"stack named train_stream ({stack_ms:.1f} ms); /metrics served "
                  f"{OBSERVED_COUNTER} {counted(text):g} and {list(core)}: ok", flush=True)

            # 29c. the group's removal frees the card
            rt.kill(actor)
            remove_placement_group(pg)
            t1 = time.perf_counter()
            wait_for(lambda: rt.available_resources().get("GPU", 0.0), lambda g: g >= 1,
                     "29c: the GPU never came back after the group was removed")
            freed_s = time.perf_counter() - t1
            print(f"29c: the group held the card ({free_held:g} GPU free), a num_gpus=1 "
                  f"task outside it was pending after {OBSERVED_PENDING_S} s and cancelled; "
                  f"the GPU was free {freed_s:.2f} s after the actor's kill and the group's "
                  f"removal: ok", flush=True)
            readings.update(ready_s=ready_s, build_s=first_stats["build_s"], first_s=first_s,
                            end_s=end_s, step_s=[x["step_s"] for x in steps],
                            io_ms=[p["ms"] for p in probes], stack_ms=stack_ms,
                            losses=losses, phases_ms=phases_ms, freed_s=freed_s)
        finally:
            rt.shutdown()
    finally:
        if saved_root is None:
            os.environ.pop("RAY_TPU_TORCH_TEMP_DIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TEMP_DIR"] = saved_root
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    readings["phase_s"] = phase_s
    print(f"phase 29 on {card}: {phase_s:.1f} s; K1-K3 launches in its actor {launches}",
          flush=True)
    return {"launches": launches, "skipped": skipped, "readings": readings}


def pin_to_one_card():
    """Phases 1-29 are written for one card. On a host with several, this
    process, and every process it starts before phase 30, sees only the
    first (CUDA_VISIBLE_DEVICES, set before CUDA starts here). Returns
    the cards a process started here would otherwise see, and
    CUDA_VISIBLE_DEVICES as it was (None when unset), which phase 30
    restores for its own processes."""
    from ray_tpu_torch.parallel.launch import visible_cards

    cards, before = visible_cards(), os.environ.get("CUDA_VISIBLE_DEVICES")
    if cards > 1:
        os.environ["CUDA_VISIBLE_DEVICES"] = before.split(",")[0] if before else "0"
    return cards, before


class all_cards:
    """Within the block, processes started here see every card the host
    gave this run (`pin_to_one_card`'s `before`); this process keeps its
    one."""

    def __init__(self, before):
        self.before = before

    def __enter__(self):
        self.pinned = os.environ.get("CUDA_VISIBLE_DEVICES")
        if self.before is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = self.before

    def __exit__(self, *exc):
        if self.pinned is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = self.pinned


def _per_rank(res):
    """Each rank's K1-K5 launches, in rank order."""
    return [{name: r["launches"].get(name, 0) for name in SOURCES} for r in res]


def nccl_launches(nccl, name):
    """Kernel `name`'s launches per rank in each sub-phase of phase 30
    (30c's by mesh) from what `phase_nccl` returns; None where phase 30
    did not run."""
    if nccl is None:
        return None
    return {sub: ({label: [x[name] for x in per] for label, per in ranks.items()}
                  if isinstance(ranks, dict) else [x[name] for x in ranks])
            for sub, ranks in nccl.items()}


def _on_own_cards(label, res, n):
    """Every rank ran over NCCL on a card of its own."""
    devices = [r["device"] for r in res]
    check(all(r["backend"] == "nccl" for r in res),
          f"{label}: backends {[r['backend'] for r in res]}")
    check(len(set(devices)) == n, f"{label}: ranks on {devices}, not a card each")


def phase_nccl_ring(A, card, ring_host):
    """30a: llama-1b sequence-parallel over NCCL_RANKS cards, all 22
    layers, against the same steps on one card; `ring_host` is phase
    14's step (None where it did not run)."""
    import functools
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM, chunked_causal_lm_loss
    from ray_tpu_torch.parallel.launch import run_llama_train, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import make_optimizer, timed_steps, train_step

    n, t = NCCL_RANKS, RING_SEQ
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, t))
    loss_fn = functools.partial(chunked_causal_lm_loss, chunk_size=RING_CHUNK)
    model = LlamaForCausalLM(cfg, device="cuda")
    optimizer = make_optimizer(model)
    ids_c = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    targets_c = torch.roll(ids_c, -1, 1)
    single, single_s = timed_steps(
        lambda: train_step(model, optimizer, ids_c, targets_c, loss_fn), NCCL_TIMED_STEPS)
    single_ms = single_s / NCCL_TIMED_STEPS * 1e3
    del model, optimizer, ids_c, targets_c
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sorted(spawn(run_llama_train, n, MeshSpec(seq=n), cfg, ids, NCCL_TIMED_STEPS, loss_fn,
                       deadline_s=NCCL_DEADLINE_S, backend="nccl"), key=lambda r: r["seq_rank"])
    seconds = time.perf_counter() - t0
    _on_own_cards("30a", res, n)
    losses, loss_rel, launches, per_step, step_ms = check_seq_parallel(
        "30a", res, single, cfg.num_layers, n, NCCL_TIMED_STEPS + 1)
    for r in res:
        wait = r["spans"].get("shift_wait", {"count": 0, "ms": 0.0})
        print(f"30a seq rank {r['seq_rank']}: {r['device']} ({r['card']}), backend "
              f"{r['backend']}, step {r['step_ms']:.1f} ms, kernels stood {wait['ms']:.2f} ms "
              f"for {wait['count']} shifts of the last step ({wait['ms'] / r['step_ms']:.2%} "
              f"of the mean step), peak memory {r['peak_memory_gb']:.2f} GB, launches "
              f"{r['launches']}", flush=True)
    hidden = max(r["spans"].get("shift_wait", {}).get("ms", 0.0) / r["step_ms"] for r in res)
    host = ("phase 14 not run" if ring_host is None else
            f"phase 14's {ring_host['step_ms']:.1f} ms host-staged on one card at "
            f"{ring_host['layers']} layers")
    print(f"30a train llama-1b seq-parallel ({cfg.num_layers} layers, seq {n}, b1, T {t}, bf16, "
          f"chunked loss) on {n} cards over NCCL ({card} each): losses {losses} against one "
          f"card's {single} (relative {loss_rel:.2e}, rtol {RING_LOSS_RTOL}), parameters equal "
          f"on every rank, step {step_ms:.1f} ms (slowest rank) against {single_ms:.1f} ms on "
          f"one card and {host}; the k/v and gradient shifts stall the kernels "
          f"{hidden:.2%} of a step at most (CUDA events around Shift.wait); launches over the "
          f"ranks {launches} ({per_step} per step); world in {seconds:.1f} s: ok", flush=True)
    return _per_rank(res)


def phase_nccl_pipeline(card):
    """30b: llama-1b as NCCL_RANKS pipeline stages, a card each, against
    the same layers in sequence on one card; each stage's idle share."""
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.parallel.launch import run_pipeline_llama, sequential_llama, spawn

    s_count, layers, m_count = NCCL_RANKS, NCCL_PIPE_LAYERS, NCCL_PIPE_MICRO
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (m_count, 1, SEQ))
    want = sequential_llama(cfg, s_count, layers, ids, NCCL_TIMED_STEPS, PIPE_LR,
                            device="cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sorted(spawn(run_pipeline_llama, s_count, cfg, layers, ids, NCCL_TIMED_STEPS, PIPE_LR,
                       deadline_s=NCCL_DEADLINE_S, backend="nccl"), key=lambda r: r["stage"])
    seconds = time.perf_counter() - t0
    _on_own_cards("30b", res, s_count)
    errs, per_step = check_pipeline("30b", res, want, layers, m_count, NCCL_TIMED_STEPS + 1,
                                    "cuda")
    idle = []
    for r in res:
        spans = r["spans"]
        idle.append(1.0 - spans["stage"]["ms"] / spans["pipeline"]["ms"])
        print(f"30b stage {r['stage']}: {r['device']} ({r['card']}), backend {r['backend']}, "
              f"step {r['step_ms']:.1f} ms, schedules {spans['pipeline']['ms']:.1f} ms of which "
              f"its {spans['stage']['count']} ticks computed {spans['stage']['ms']:.1f} ms: idle "
              f"{idle[-1]:.3f}; peak memory {r['peak_memory_gb']:.2f} GB, launches "
              f"{r['launches']}", flush=True)
    step_ms = max(r["step_ms"] for r in res)
    print(f"30b pipeline llama-1b ({s_count * layers} of 22 layers as {s_count} stages of "
          f"{layers}, {m_count} microbatches of b1 s{SEQ}, bf16, SGD {PIPE_LR} on mean(y^2)) on "
          f"{s_count} cards over NCCL ({card} each): y and {sum(len(g) for g in want['grads'])} "
          f"grads against the layers in sequence on one card {fmt(worst(*errs))}, limit rel "
          f"{REL_TOL}; losses {res[0]['losses']} against {want['losses']} (rtol "
          f"{RING_LOSS_RTOL}); step {step_ms:.1f} ms (slowest stage) against {want['step_ms']:.1f} "
          f"ms in sequence on one card; measured idle share per stage "
          f"{[round(x, 3) for x in idle]} (the schedule's (S-1)/(M+S-1) = "
          f"{(s_count - 1) / (m_count + s_count - 1):.3f}); launches per rank {per_step} per "
          f"step; world in {seconds:.1f} s: ok", flush=True)
    return _per_rank(res)


def phase_nccl_trainer(card):
    """30d: TorchTrainer of NCCL_RANKS GPU workers over NCCL, llama-1b
    data-parallel, against one card's accumulation over the same global
    batch."""
    import shutil
    from dataclasses import replace

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.parallel.launch import accumulated_llama, data_parallel_loop

    n, b = NCCL_RANKS, NCCL_TRAINER_BATCH
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (n * b, SEQ))
    want = accumulated_llama(cfg, ids, b, NCCL_TIMED_STEPS, device="cuda")
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_nccl_trainer_")
    rt.init()
    try:
        gpus = rt.cluster_resources().get("GPU")
        check(gpus == n, f"30d: the runtime detected {gpus} GPUs, expected {n}")
        t0 = time.perf_counter()
        result = train.TorchTrainer(
            data_parallel_loop,
            train_loop_config={"cfg": cfg, "ids": ids, "steps": NCCL_TIMED_STEPS},
            scaling_config=train.ScalingConfig(num_workers=n, use_gpu=True,
                                               use_torch_distributed=True),
            run_config=train.RunConfig(storage_path=os.path.join(scratch, "results")),
        ).fit()
        fit_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    check(result.error is None, f"30d: TorchTrainer failed: {result.error}")
    res = sorted(result.metrics["ranks"], key=lambda r: r["rank"])
    check(len(res) == n, f"30d: {len(res)} workers reported")
    check(all(r["backend"] == "nccl" for r in res), f"30d: backends {[r['backend'] for r in res]}")
    visible = [r["visible"] for r in res]
    check(len(set(visible)) == n and all(v and "," not in v for v in visible),
          f"30d: the workers see CUDA_VISIBLE_DEVICES {visible}, not a card each")
    losses = res[0]["losses"]
    check(all(r["losses"] == losses for r in res), "30d: ranks report different losses")
    check(all(r["param_digest"] == res[0]["param_digest"] for r in res),
          "30d: ranks hold different parameters after the steps")
    rel = [abs(a - c) / abs(c) for a, c in zip(losses, want["losses"])]
    check(max(rel) <= TRAINER_LOSS_RTOL,
          f"30d: losses {losses} vs one card's accumulation {want['losses']}: relative {rel}")
    check(losses[-1] < losses[0], f"30d: loss did not fall: {losses}")
    steps, layers = NCCL_TIMED_STEPS + 1, cfg.num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    for r in res:
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"30d rank {r['rank']}: {name} launched {r['launches'][name]} times in "
                  f"{steps} steps, expected {k * steps}")
        reduce = r["spans"].get("grad_all_reduce", {"ms": 0.0})
        print(f"30d worker {r['rank']}: CUDA_VISIBLE_DEVICES={r['visible']} ({r['card']}), "
              f"backend {r['backend']}, step {r['step_ms']:.1f} ms, gradient all-reduce "
              f"{reduce['ms']:.2f} ms of the last step, peak memory {r['peak_memory_gb']:.2f} GB, "
              f"launches {r['launches']}", flush=True)
    print(f"30d TorchTrainer(ScalingConfig(num_workers={n}, use_gpu=True, "
          f"use_torch_distributed=True)) llama-1b b{b} s{SEQ} a worker, bf16, over NCCL "
          f"({card} each): losses {losses} against one card accumulating the global batch of "
          f"{n * b} {want['losses']} (relative {max(rel):.2e}, rtol {TRAINER_LOSS_RTOL}), "
          f"parameters equal on every worker, step {max(r['step_ms'] for r in res):.1f} ms "
          f"(slowest worker) against {want['step_ms']:.1f} ms on one card for {n} times the "
          f"rows; launches per worker {per_step} per step; fit() {fit_s:.1f} s: ok", flush=True)
    return _per_rank(res)


def phase_nccl_sharded(card, in_process):
    """30e: llama-1b placed by shard_params on fsdp 2 x tensor 2, a card
    per rank, taking phase 5's steps against phase 5's losses."""
    from dataclasses import replace

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import CONFIGS
    from ray_tpu_torch.parallel.launch import run_sharded_train, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec

    spec = MeshSpec(**NCCL_SHARDED)
    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (BATCH, SEQ))  # phase 5's
    t0 = time.perf_counter()
    res = sorted(spawn(run_sharded_train, spec.num_devices, spec, cfg, ids, TIMED_STEPS,
                       deadline_s=NCCL_DEADLINE_S, backend="nccl"),
                 key=lambda r: (r["fsdp_rank"], r["tensor_rank"]))
    seconds = time.perf_counter() - t0
    _on_own_cards("30e", res, spec.num_devices)
    losses = res[0]["losses"]
    check(all(r["losses"] == losses for r in res), "30e: ranks report different losses")
    check(all(math.isfinite(x) for x in losses), f"30e: loss not finite: {losses}")
    rel = [abs(a - c) / abs(c) for a, c in zip(losses, in_process["losses"])]
    check(max(rel) <= RING_LOSS_RTOL,
          f"30e: losses {losses} vs phase 5's {in_process['losses']}: relative {rel}")
    check(losses[-1] < losses[0], f"30e: loss did not fall: {losses}")
    steps, layers = TIMED_STEPS + 1, cfg.num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers, "flash_bwd_dq": layers}
    for r in res:
        for name, k in per_step.items():
            check(r["launches"][name] == k * steps,
                  f"30e rank fsdp {r['fsdp_rank']} tensor {r['tensor_rank']}: {name} launched "
                  f"{r['launches'][name]} times in {steps} steps, expected {k * steps}")
        print(f"30e rank fsdp {r['fsdp_rank']} tensor {r['tensor_rank']}: {r['device']} "
              f"({r['card']}), backend {r['backend']}, step {r['step_ms']:.1f} ms, peak memory "
              f"{r['peak_memory_gb']:.2f} GB against phase 5's "
              f"{in_process['peak_memory_gb']:.2f} GB on one card", flush=True)
    print(f"30e train llama-1b placed by shard_params on fsdp {NCCL_SHARDED['fsdp']} x tensor "
          f"{NCCL_SHARDED['tensor']} (tensor plan, then FSDP2; b{BATCH} s{SEQ}, bf16, AdamW) on "
          f"{spec.num_devices} cards over NCCL ({card} each): losses {losses} against phase 5's "
          f"{in_process['losses']} (relative {max(rel):.2e}, rtol {RING_LOSS_RTOL}), step "
          f"{max(r['step_ms'] for r in res):.1f} ms (slowest rank) against phase 5's "
          f"{in_process['step_ms']:.1f} ms, peak memory per rank "
          f"{[round(r['peak_memory_gb'], 2) for r in res]} GB against "
          f"{in_process['peak_memory_gb']:.2f} GB; launches per rank {per_step} per step; world "
          f"in {seconds:.1f} s: ok", flush=True)
    return _per_rank(res)


def phase_nccl(A, card, cards, before, in_process, ring_host, mesh_single):
    """Phase 30: the layouts with one card per rank over NCCL (30a-30e),
    where the host gave this run NCCL_RANKS cards or more (`cards`);
    on fewer, one line and nothing else. Returns each sub-phase's K1-K5
    launches per rank, or None."""
    if cards < NCCL_RANKS:
        print(f"phase 30: the layouts with one card per rank over NCCL need {NCCL_RANKS} cards; "
              f"this host has {cards}, so none runs (nothing falls back to gloo, host memory "
              f"or the CPU)", flush=True)
        return None
    import torch

    launches = {}
    with all_cards(before):
        launches["30a"] = phase_nccl_ring(A, card, ring_host)
        torch.cuda.empty_cache()
        launches["30b"] = phase_nccl_pipeline(card)
        torch.cuda.empty_cache()
        ranks = {}
        phase_meshes(card, backend="nccl", label="30c", single=mesh_single, ranks=ranks)
        torch.cuda.empty_cache()
        for label, r in ranks.items():
            if dict((c[0], c[2]) for c in MESH_CASES)[label] == "gmm":
                check(all(x["gmm"] > 0 and x["tgmm"] > 0 for x in r["launches"]),
                      f"30c {label}: a rank launched no K4 or K5: {r['launches']}")
        launches["30c"] = {label: [{name: x.get(name, 0) for name in SOURCES}
                                   for x in r["launches"]] for label, r in ranks.items()}
        launches["30d"] = phase_nccl_trainer(card)
        torch.cuda.empty_cache()
        launches["30e"] = phase_nccl_sharded(card, in_process)
        torch.cuda.empty_cache()
    return launches


def routes_moved(one, ranks):
    """Tokens whose top-k experts differ between a split and one process,
    by step and layer, over the whole batch: each block counted once (on
    its tensor rank 0) against one process's choices for the same
    tokens (`launch.mixtral_routes`)."""
    moved = []
    for s, layers in enumerate(one):
        row = []
        for layer, picks in enumerate(layers):
            n = 0
            for r in ranks:
                if r["tensor_rank"] == 0:
                    (r0, r1), (c0, c1) = r["block"]
                    n += int((r["routes"][s][layer] != picks[r0:r1, c0:c1]).any(-1).sum())
            row.append(n)
        moved.append(row)
    return moved


def phase_bf16_split(card, cards, before, spec=None, backend="nccl"):
    """`--phase 30c-bf16`: 27a's tensor case (`BF16_SPLIT_AXES`,
    "capacity") in the spec's dtypes, bf16 on the card, over
    `backend` beside one process, for BF16_SPLIT_STEPS steps. Prints the
    loss gap and the tokens the split moved between experts (`routes_moved`)
    per step and layer; nothing is held to RING_LOSS_RTOL. Returns them,
    or None where the host has fewer cards than ranks."""
    import numpy as np
    import torch
    from contextlib import nullcontext
    from dataclasses import replace

    from ray_tpu_torch.models.mixtral import CONFIGS, MixtralForCausalLM, moe_lm_loss
    from ray_tpu_torch.parallel.launch import mixtral_routes, run_mixtral_routes, spawn
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import train_step

    spec = spec or mesh_spec(steps=BF16_SPLIT_STEPS)
    nccl, device, steps = backend == "nccl", spec["device"], spec["steps"]
    ranks = math.prod(BF16_SPLIT_AXES.values())
    if nccl and cards < ranks:
        print(f"30c-bf16: needs {ranks} cards, this host has {cards}; nothing runs", flush=True)
        return None
    cfg = replace(CONFIGS[spec["model"]], moe_dispatch="capacity",
                  param_dtype=getattr(torch, spec["param_dtype"]),
                  dtype=getattr(torch, spec["dtype"]))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (spec["batch"], spec["seq"]))
    model = MixtralForCausalLM(cfg, device=device)
    ids_d = torch.as_tensor(ids, dtype=torch.long, device=device)
    targets = torch.roll(ids_d, -1, 1)
    t0 = time.perf_counter()
    one = mixtral_routes(model, ids_d, steps,
                         lambda opt: train_step(model, opt, ids_d, targets, moe_lm_loss))
    one_s = time.perf_counter() - t0
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with all_cards(before) if nccl else nullcontext():
        res = spawn(run_mixtral_routes, ranks, MeshSpec(**BF16_SPLIT_AXES), cfg, ids, steps,
                    *(("cpu",) if device == "cpu" else ()), deadline_s=NCCL_DEADLINE_S,
                    backend=backend)
    split_s = time.perf_counter() - t0
    if nccl:
        _on_own_cards("30c-bf16", res, ranks)
    losses = res[0]["losses"]
    check(all(r["losses"] == losses for r in res), "30c-bf16: ranks report different losses")
    check(all(math.isfinite(x) for x in losses + one["losses"]),
          f"30c-bf16: a loss is not finite: {losses} against {one['losses']}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
    moved = routes_moved(one["routes"], res)
    tokens = spec["batch"] * spec["seq"]
    axes_s = " x ".join(f"{a} {n}" for a, n in BF16_SPLIT_AXES.items())
    for s, (a, b, gap, row) in enumerate(zip(losses, one["losses"], gaps, moved)):
        print(f"30c-bf16 step {s}: loss {a:.6f} on {axes_s}, {b:.6f} on one card, relative "
              f"gap {gap:.3e}; tokens moved per layer {row} of {tokens}", flush=True)
    where = f"{ranks} cards over NCCL" if nccl else f"{ranks} ranks over {backend}"
    print(f"30c-bf16: {spec['model']} b{spec['batch']} s{spec['seq']} ({cfg.moe_dispatch}, "
          f"{spec['param_dtype']} parameters, {spec['dtype']} compute) on {card}, {where}, "
          f"{steps} steps: largest relative loss gap {max(gaps):.3e} (27a and 30c hold the "
          f"float32 case to {RING_LOSS_RTOL}; this is a measurement), tokens moved per layer "
          f"{min(map(min, moved))}-{max(map(max, moved))} of {tokens}; one card "
          f"{one_s:.1f} s, the split {split_s:.1f} s", flush=True)
    return {"losses": losses, "one_card_losses": one["losses"], "relative_gaps": gaps,
            "tokens_moved": moved, "tokens": tokens}


def phase30c_bf16_alone(card, cards, before) -> int:
    """`chip_smoke.py --phase 30c-bf16`: `phase_bf16_split` alone; prints
    its numbers as the last line."""
    out = phase_bf16_split(card, cards, before)
    phase_done("30c-bf16")
    print(json.dumps({"bf16_split": out}), flush=True)
    return 0 if out is not None else 1


def phase30_alone(A, card, cards, before) -> int:
    """`chip_smoke.py --phase 30`: phase 5's steps (30e's yardstick), then
    phase 30 alone; prints its launches per rank as the last line."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    model = LlamaForCausalLM(replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16),
                             device="cuda")
    torch.cuda.reset_peak_memory_stats()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    print(f"phase 5 (30e's yardstick): losses {r['losses']}, step {r['step_ms']:.1f} ms, peak "
          f"memory {r['peak_memory_gb']:.2f} GB", flush=True)
    phase_done("5")
    nccl = phase_nccl(A, card, cards, before, r, None, {})
    phase_done("30")
    print(json.dumps({"nccl_launches": nccl}), flush=True)
    return 0 if nccl is not None else 1


def main() -> int:
    if sys.argv[1:] == ["--job-driver"]:
        return job_driver()
    if sys.argv[1:2] == ["--client-driver"]:
        return client_driver(*sys.argv[2:])
    # Before anything here starts CUDA: phases 1-29 see one card.
    cards, before = pin_to_one_card()
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
    if sys.argv[1:] == ["--phase", "30"]:
        return phase30_alone(A, card, cards, before)
    if sys.argv[1:] == ["--phase", "30c-bf16"]:
        return phase30c_bf16_alone(card, cards, before)
    try:
        import gymnasium

        print(f"gymnasium {gymnasium.__version__} (phase 22's CartPole)", flush=True)
    except ImportError:
        print("gymnasium is not installed: phase 22 holds the learner on batches built "
              "without an env", flush=True)
    phase_done("1-2")

    # 3. attention kernels
    numbers = phase_kernels(A)
    phase_done("3")
    # 4. grouped-matmul kernels
    numbers.update(phase_gmm(G))
    torch.cuda.empty_cache()
    phase_done("4")

    # 5. Llama train: the Llama path, counted from zero
    from dataclasses import replace

    cfg = replace(CONFIGS["llama-1b"], param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda")
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    r = bench_model(model, BATCH, SEQ, TIMED_STEPS, H100_BF16_PEAK_FLOPS)
    r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9  # phase 30e's yardstick
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
    phase_done("5")

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
    phase_done("6")

    # 7. MoE dispatch: gmm against the ragged oracle
    phase_moe_dispatch(M, card)
    torch.cuda.empty_cache()
    phase_done("7")

    # 8. Mixtral train: the Mixtral path, counted from zero
    moe_launches = phase_mixtral(A, G, M, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    phase_done("8")

    # 9. dispatch probe
    phase_probe(M)
    torch.cuda.empty_cache()
    phase_done("9")

    # 10. attention kernels at the long-context and GPT shapes
    phase_long_kernels(A)
    phase_done("10")
    # 11. GPT: parity on a small input, then the gpt2-large path counted from zero
    phase_gpt(A, card, bench_model, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    phase_done("11")
    # 12. the long-context sweep, counted from zero
    phase_longctx(A, card, H100_BF16_PEAK_FLOPS)
    torch.cuda.empty_cache()
    phase_done("12")
    # 13. ring blocks in one process
    phase_ring_blocks(A)
    phase_done("13")
    # 14. the ring over RING_RANKS processes on the card, counted in each rank
    ring_host = phase_ring(A, card)
    torch.cuda.empty_cache()
    phase_done("14")
    # 15. the pipeline over PIPE_STAGES processes, counted in each rank
    phase_pipeline(A, card)
    torch.cuda.empty_cache()
    phase_done("15")
    # 16. expert parallelism over data x expert processes, counted in each rank
    phase_expert(A, card)
    torch.cuda.empty_cache()
    phase_done("16")
    # 17. the runtime: the card detected, tensors through the object store
    phase_object_plane(card)
    phase_done("17")
    # 18. TorchTrainer at llama-1b in a GPU worker, counted in the worker
    trainer_step_ms = phase_trainer(A, card, llama_in_process)
    phase_done("18")
    import ray_tpu_torch as rt

    rt.init()
    try:
        # 19. Data -> TorchTrainer -> llama-1b, counted in the worker
        phase_data_trainer(card, llama_in_process, trainer_step_ms)
        phase_done("19")
        # 20. collectives with CUDA tensors between two actors on the card
        phase_collectives(card)
        phase_done("20")
        # 21. Tune: two trials of llama-1b queued on the card, counted in each worker
        phase_tune(card, llama_in_process)
        phase_done("21")
        # 22. RLlib PPO with its learner on the card
        phase_ppo(card)
        phase_done("22")
        # 23. Serve: a num_gpus=1 llama-1b replica, K1 counted in the replica
        serve_launches = phase_serve(card)
        phase_done("23")
        # 24. the rest of RLlib: every other learner on the card, offline
        # data, multi-agent, DreamerV3
        phase_rllib(card)
    finally:
        rt.shutdown()
    phase_done("24")
    # 25. a job on an autoscaled GPU node, K1-K3 counted in its task
    job_launches = phase_job(card, llama_in_process)
    phase_done("25")
    # 26. the rest of the surface: a compiled DAG, a workflow, a thin
    # client and a pip env, each counted in its worker
    surface = phase_surface(card, llama_in_process)
    torch.cuda.empty_cache()
    phase_done("26")
    # 27. Mixtral's other meshes over 4 processes, counted in each rank; a
    # C caller of a llama-1b actor, counted in the actor; the native
    # store and codec
    mesh_single = {}  # the one-card steps of each case, which 30c reuses
    mesh_launches_by_case = phase_meshes(card, single=mesh_single)
    torch.cuda.empty_cache()
    c_client = phase_c_client(card)
    torch.cuda.empty_cache()
    phase_done("27")
    # 28. the runtime under faults: an actor restart and a task retry on
    # the card under a seeded chaos schedule, K1-K3 counted in the
    # workers; the lock witness in every process
    faults = phase_faults(card, llama_in_process)
    phase_done("28")
    # 29. a GPU actor observed through the runtime: a stream of train steps
    # from its compute group, io calls while it runs, a placement group
    # holding the card, and the events, timeline, /metrics and stack
    # profile the runtime recorded; K1-K3 counted in the actor
    observed = phase_observed(card, llama_in_process)
    phase_done("29")
    # 30. the layouts with one card per rank over NCCL: the ring, the
    # pipeline, Mixtral's meshes, TorchTrainer and shard_params, K1-K5
    # counted per rank; on a host with fewer than NCCL_RANKS cards, one line
    nccl = phase_nccl(A, card, cards, before, llama_in_process, ring_host, mesh_single)
    phase_done("30")

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
        # Phase 26's paths: 26a's compiled DAG, 26c's thin client and 26d's
        # pip env launch K1; 26b's workflow K1-K3.
        if name in surface["launches"]["workflow"]:
            kernels[-1]["workflow_launches"] = surface["launches"]["workflow"][name]
        if name == "flash_fwd":
            kernels[-1].update(dag_launches=surface["launches"]["dag"],
                               client_launches=surface["launches"]["client"],
                               pip_launches=surface["launches"]["pip"],
                               c_client_launches=c_client["launches"]["flash_fwd"])
        # Phase 27a's meshes, summed over their ranks.
        kernels[-1]["mesh_launches"] = {label: n[name]
                                        for label, n in mesh_launches_by_case.items()}
        # Phase 28's workers: 28a's actor in both incarnations (K1) and
        # 28b's retry (K1-K3).
        if name in faults["launches"]:
            kernels[-1]["fault_launches"] = faults["launches"][name]
        # Phase 29's actor: its stream of train steps (K1-K3).
        if name in observed["launches"]:
            kernels[-1]["observed_launches"] = observed["launches"][name]
        kernels[-1]["nccl_launches"] = nccl_launches(nccl, name)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
