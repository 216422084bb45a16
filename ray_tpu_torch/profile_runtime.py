"""What the port's runtime costs: the object plane's put and get split
into their parts, and the host's CPU around a train step in process and
in a `TorchTrainer` worker.

    python -m ray_tpu_torch.profile_runtime [--model llama-1b] [--batch 2]
        [--seq 2048] [--mib 64] [--fits 2] [--device cuda]

The object plane: a bf16 tensor of `--mib` MiB on the device; the
device-to-host copy alone, the pickling alone (which makes that copy),
`put` of the host copy (pickling and the write into shared memory),
`put` of the device tensor, `get` in the putting process and in a
one-GPU actor (the copy out of the mapping), beside a plain memcpy into
fresh and into touched host memory. Each the median of 3.

The step: the model built as `chip_smoke.py`'s phase 5 builds it,
`bench_model`'s one warm-up and 3 timed steps, twice on the model, in
this process's main thread and in a new thread of it before the runtime
starts, then in the trainer's worker `--fits` times (whose loop runs in
a thread of the worker actor). Around each `bench_model` call it reads from `/proc` the CPU seconds
and involuntary context switches of every thread of the stepping
process, and the CPU seconds of every other process on the host, and
prints those that used any, with the stepping thread's and process's
CPU clocks and the garbage collector's collections per generation. A thread of the stepping process that
burns CPU beside the loop holds the GIL from it; another process that
does takes cores from it.

`--device cpu` runs the same at a small size on the CPU (llama-tiny,
`use_gpu=False`) to rehearse it.

    python -m ray_tpu_torch.profile_runtime --tasks 2000

runs only the task path instead, on a runtime of TASK_CPUS CPUs: tasks/s
of a burst of that many no-op tasks submitted at once and then gathered,
in each of TASK_ROUNDS rounds, through leased workers and then with the
leased route turned off, so that every task goes through the head.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import tempfile
import threading
import time
from dataclasses import replace

import numpy as np
import torch

REPEATS = 3
TASK_CPUS, TASK_ROUNDS = 4, 3
# bench_model calls on one model in each place the step runs.
ROUNDS = 2


def _ticks(stat: str):
    """utime + stime in seconds from a /proc stat line."""
    fields = stat[stat.rindex(")") + 2:].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def cpu_snapshot():
    """(threads, processes): this process's threads as tid -> (name, CPU
    s, involuntary switches), every other process as pid -> (command,
    CPU s)."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    threads = {}
    for tid in os.listdir("/proc/self/task"):
        base = f"/proc/self/task/{tid}"
        try:
            cpu = _ticks(_read(f"{base}/stat"))
            name = names.get(int(tid)) or _read(f"{base}/comm").strip()
            # Not every kernel's /proc (a sandbox's) counts the switches.
            found = re.search(r"nonvoluntary_ctxt_switches:\s+(\d+)", _read(f"{base}/status"))
        except OSError:
            continue
        switches = int(found.group(1)) if found else 0
        threads[int(tid)] = (name, cpu, switches)
    processes = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            cpu = _ticks(_read(f"/proc/{pid}/stat"))
            cmd = _read(f"/proc/{pid}/cmdline").replace("\0", " ").strip()
        except OSError:
            continue
        processes[int(pid)] = (cmd[:100] or f"[{pid}]", cpu)
    return threads, processes


def cpu_delta(before, after, wall_s: float):
    """What each thread and process used between two snapshots."""
    (t0, p0), (t1, p1) = before, after
    threads = [
        {"thread": name, "cpu_s": round(cpu - t0.get(tid, (name, 0.0, 0))[1], 3),
         "involuntary_switches": sw - t0.get(tid, (name, 0.0, 0))[2]}
        for tid, (name, cpu, sw) in t1.items()
    ]
    threads = sorted((t for t in threads if t["cpu_s"] > 0 or t["involuntary_switches"]),
                     key=lambda t: -t["cpu_s"])
    procs = [{"process": cmd, "cpu_s": round(cpu - p0.get(pid, (cmd, 0.0))[1], 3)}
             for pid, (cmd, cpu) in p1.items()]
    procs = sorted((p for p in procs if p["cpu_s"] > 0), key=lambda p: -p["cpu_s"])
    return {"wall_s": round(wall_s, 3), "threads": threads, "other_processes": procs[:12],
            "cores": len(os.sched_getaffinity(0))}


def build_and_step(config):
    """phase 5's model and `bench_model`, with the CPU used around it."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS, bench_model
    from ray_tpu_torch.models.llama import CONFIGS, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CONFIGS[config["model"]]
    if config["device"] == "cuda":
        cfg = replace(cfg, param_dtype=torch.bfloat16)
    threads = torch.get_num_threads()
    if config["device"] == "cpu":
        # The rehearsal's small steps gain nothing from an intra-op pool,
        # and on a loaded host each process's pool spins against the
        # others' (every round several times slower).
        torch.set_num_threads(1)
    try:
        model = LlamaForCausalLM(cfg, device=config["device"])
        rounds = []
        for _ in range(ROUNDS):
            collections = [g["collections"] for g in gc.get_stats()]
            before, t0 = cpu_snapshot(), time.perf_counter()
            mine, process = time.thread_time(), time.process_time()
            r = bench_model(model, config["batch"], config["seq"], 3, H100_BF16_PEAK_FLOPS)
            mine, process = time.thread_time() - mine, time.process_time() - process
            usage = cpu_delta(before, cpu_snapshot(), time.perf_counter() - t0)
            # The clocks, where /proc lists no threads.
            usage["loop_thread_cpu_s"] = round(mine, 3)
            usage["process_cpu_s"] = round(process, 3)
            usage["gc_collections"] = [g["collections"] - n
                                       for g, n in zip(gc.get_stats(), collections)]
            rounds.append({"step_ms": r["step_ms"], "losses": r["losses"], "usage": usage})
    finally:
        torch.set_num_threads(threads)
    return {"thread": threading.current_thread().name,
            "step_ms": [r["step_ms"] for r in rounds], "rounds": rounds}


def step_in_thread(config):
    """`build_and_step` in a new thread of this process, as the trainer's
    worker runs its loop."""
    out = {}
    t = threading.Thread(target=lambda: out.update(build_and_step(config)))
    t.start()
    t.join()
    return out


def trainer_loop(config):
    from ray_tpu_torch import train

    train.report(build_and_step(config))


def fmt(result) -> str:
    return ", ".join(f"{ms:.1f}" for ms in result["step_ms"])


def _median_ms(fn) -> float:
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def object_plane(rt, mib: int, device: str):
    """Each part of a put and a get of a `mib` MiB bf16 tensor, in ms."""
    from ray_tpu_torch._private import serialization

    n = mib * 1024 * 1024 // 2
    x = torch.randn(n, generator=torch.Generator(device=device).manual_seed(17),
                    device=device, dtype=torch.bfloat16)
    host = x.cpu()
    raw = host.view(torch.uint8).numpy()
    touched = np.empty_like(raw)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ms = {
        "memcpy_fresh": _median_ms(lambda: np.copyto(np.empty_like(raw), raw)),
        "memcpy_touched": _median_ms(lambda: np.copyto(touched, raw)),
        "device_to_host": _median_ms(lambda: (x.cpu(), sync())),
        "pickle": _median_ms(lambda: serialization.dumps(x)),
        "put_host_tensor": _median_ms(lambda: rt.put(host)),
        "put": _median_ms(lambda: rt.put(x)),
    }
    ref = rt.put(x)
    ms["get_here"] = _median_ms(lambda: rt.get(ref))

    @rt.remote(num_gpus=1 if device == "cuda" else 0)
    class Taker:
        def get_ms(self, refs):
            return _median_ms(lambda: rt.get(refs[0]))

    taker = Taker.remote()
    ms["get_in_actor"] = rt.get(taker.get_ms.remote([ref]), timeout=300)
    rt.kill(taker)
    gb = mib * 1024 * 1024 / 1e9
    return {k: {"ms": round(v, 3), "GB/s": round(gb / (v / 1e3), 3)} for k, v in ms.items()}


def task_bursts(rt, n: int):
    """Tasks/s of each round's burst of n no-op tasks, by route."""
    from ray_tpu_torch._private.worker import global_client

    @rt.remote
    def noop(i):
        return i

    client = global_client()
    rates = {}
    try:
        for route in ("lease", "head"):
            if route == "head":
                client._lease_eligible = lambda spec: False
            rt.get([noop.remote(i) for i in range(100)])
            rates[route] = []
            for _ in range(TASK_ROUNDS):
                t0 = time.perf_counter()
                if rt.get([noop.remote(i) for i in range(n)]) != list(range(n)):
                    raise RuntimeError("a burst of no-op tasks answered wrongly")
                rates[route].append(round(n / (time.perf_counter() - t0), 1))
    finally:
        client.__dict__.pop("_lease_eligible", None)
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="llama-1b on the card, llama-tiny on the CPU")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=None, help="2048 on the card, 64 on the CPU")
    ap.add_argument("--mib", type=int, default=None, help="64 on the card, 4 on the CPU")
    ap.add_argument("--fits", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tasks", type=int, default=0,
                    help="time bursts of this many no-op tasks instead")
    args = ap.parse_args(argv)
    if args.tasks:
        import ray_tpu_torch as rt

        rt.init(num_cpus=TASK_CPUS, num_gpus=0)
        try:
            rates = task_bursts(rt, args.tasks)
        finally:
            rt.shutdown()
        print(json.dumps({"task_bursts": rates, "tasks": args.tasks, "cpus": TASK_CPUS,
                          "host_cores": os.cpu_count()}), flush=True)
        return 0
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to rehearse on the CPU")
    config = {"model": args.model or ("llama-1b" if cuda else "llama-tiny"),
              "batch": args.batch, "seq": args.seq or (2048 if cuda else 64),
              "device": args.device}

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    # By reference, so that the workers import this module rather than
    # unpickle `__main__`'s globals.
    from ray_tpu_torch.profile_runtime import object_plane, trainer_loop

    card = "cpu"
    if cuda:
        from ray_tpu_torch._device import card_description
        from ray_tpu_torch.ops import _build

        card = card_description()
        _build.build()
    print(card, flush=True)

    in_process = build_and_step(config)
    print(json.dumps({"in_process": in_process}), flush=True)
    if cuda:
        torch.cuda.empty_cache()
    in_thread = step_in_thread(config)
    print(json.dumps({"in_thread": in_thread}), flush=True)
    if cuda:
        torch.cuda.empty_cache()
        rt.init()
    else:
        rt.init(num_cpus=2, num_gpus=0)
    try:
        planes = object_plane(rt, args.mib or (64 if cuda else 4), args.device)
        print(json.dumps({"object_plane": planes, "card": card}), flush=True)
        for i in range(args.fits):
            with tempfile.TemporaryDirectory() as d:
                result = train.TorchTrainer(
                    trainer_loop, train_loop_config=config,
                    scaling_config=train.ScalingConfig(num_workers=1, use_gpu=cuda),
                    run_config=train.RunConfig(storage_path=d)).fit()
            if result.error is not None:
                raise result.error
            m = result.metrics
            print(json.dumps({f"trainer_{i}": m}), flush=True)
            print(f"fit {i} on {card}: step ms in the worker {fmt(m)}, in this process's "
                  f"main thread {fmt(in_process)}, in a new thread of it {fmt(in_thread)}",
                  flush=True)
    finally:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
