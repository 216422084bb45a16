"""TorchTrainer: gang-scheduled training over actor worker groups.

Reference call stack (SURVEY.md §3.3): TorchTrainer.fit →
BackendExecutor + WorkerGroup actors + per-worker _TrainSession with a
report queue → TrainingIterator drains epoch results. This trainer
keeps that architecture — N worker actors gang-placed via a placement
group, session report contract, checkpoint persistence, group restart
on failure (FailureConfig). With `use_gpu` each worker is a GPU worker
of the runtime: it sees its one card as cuda:0 (CUDA_VISIBLE_DEVICES is
set when its process is spawned) and fails if it sees none. With
`use_torch_distributed` and more than one worker, rank 0's address
seeds `torch.distributed.init_process_group` (brokered through the
control plane KV, replacing the reference's NCCLUniqueIDStore actor —
util/collective/util.py:9): NCCL where the workers see cards, gloo
where they do not.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from .._private.config import temp_root
from ..exceptions import RayActorError
from ..util.placement_group import placement_group, remove_placement_group
from ..util.scheduling_strategies import PlacementGroupSchedulingStrategy
from .checkpoint import Checkpoint
from .config import Result, RunConfig, ScalingConfig
from .session import TrainContext, get_session, init_session


class TrainWorker:
    """Actor wrapping one training process (reference:
    RayTrainWorker — train/_internal/worker_group.py)."""

    def __init__(self, rank: int, world_size: int, experiment_name: str,
                 storage_path: Optional[str], use_torch_distributed: bool = False,
                 use_gpu: bool = False, rendezvous_token: str = ""):
        self.rank = rank
        self.world_size = world_size
        self.session = init_session(
            TrainContext(
                world_rank=rank,
                world_size=world_size,
                local_rank=rank,
                node_rank=rank,
                experiment_name=experiment_name,
                storage_path=storage_path,
            )
        )
        self._thread: Optional[threading.Thread] = None
        if use_gpu:
            import torch

            # No fallback: a worker that holds a GPU and sees no card
            # never runs the loop on the CPU.
            if torch.cuda.device_count() < 1:
                raise RuntimeError(
                    f"train worker {rank} holds a GPU but sees no CUDA "
                    "device (CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})"
                )
            torch.cuda.set_device(0)
        if use_torch_distributed and world_size > 1:
            # Rank 0 binds the rendezvous and publishes its address
            # through the GCS KV; other ranks poll for it (reference:
            # the named NCCLUniqueIDStore actor, util/collective/util.py:9).
            addr = self._rendezvous(f"{experiment_name}/{rendezvous_token}")
            import torch
            import torch.distributed as dist

            dist.init_process_group(
                backend="nccl" if torch.cuda.is_available() else "gloo",
                init_method=f"tcp://{addr}",
                rank=rank,
                world_size=world_size,
            )

    def _rendezvous(self, rendezvous_id: str) -> str:
        """rendezvous_id is unique per fit attempt (the driver mints a
        fresh token for every _fit_once) so a group restart can never
        read the previous attempt's dead coordinator address."""
        from .._private import transport
        from .._private.worker import global_client

        client = global_client()
        key = f"train_coordinator/{rendezvous_id}".encode()
        if self.rank == 0:
            import socket

            s = socket.socket()
            s.bind(("", 0))
            port = s.getsockname()[1]
            s.close()
            addr = f"{transport.node_ip()}:{port}"
            client.kv_put(key, addr.encode())
            return addr
        deadline = time.time() + 60
        while time.time() < deadline:
            val = client.kv_get(key)
            if val:
                return val.decode()
            time.sleep(0.1)
        raise TimeoutError("torch.distributed rendezvous address never published")

    def run(self, train_loop: Callable, config: Dict[str, Any],
            latest_checkpoint: Optional[str] = None) -> bool:
        """Start the user loop in a background thread; results stream
        through next_result()."""
        self.session.context.latest_checkpoint = (
            Checkpoint(latest_checkpoint) if latest_checkpoint else None
        )

        def runner():
            try:
                # The user loop may take (config) or no args (reference:
                # train_loop_per_worker signature detection).
                import inspect

                if len(inspect.signature(train_loop).parameters) >= 1:
                    train_loop(config or {})
                else:
                    train_loop()
                self.session.finish()
            except BaseException as e:  # noqa: BLE001
                traceback.print_exc()
                self.session.finish(e)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        return True

    def next_result(self):
        kind, metrics, checkpoint = self.session.next_result()
        if kind == "done":
            err = self.session.error
            if err is not None:
                raise err if isinstance(err, Exception) else RuntimeError(str(err))
            return ("done", None, None)
        # Checkpoints are directories on shared storage; ship the path.
        ckpt_path = checkpoint.path if isinstance(checkpoint, Checkpoint) else checkpoint
        return (kind, metrics, ckpt_path)

    def ping(self):
        return self.rank


class TorchTrainer:
    """Reference: train/torch/torch_trainer.py TorchTrainer over
    train/data_parallel_trainer.py:25 DataParallelTrainer; fit() contract
    from base_trainer.py:567."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}

    # ------------------------------------------------------------------ fit

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        name = self.run_config.name or f"TorchTrainer_{int(time.time())}"
        storage = self.run_config.storage_path or os.path.join(
            temp_root(), "results", name
        )
        os.makedirs(storage, exist_ok=True)
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        latest_ckpt: Optional[str] = None
        while True:
            try:
                return self._fit_once(name, storage, latest_ckpt)
            except RayActorError as e:
                attempt += 1
                if max_failures >= 0 and attempt > max_failures:
                    return Result(
                        metrics=None, checkpoint=None, error=e, path=storage
                    )
                latest_ckpt = self._latest_checkpoint_path(storage)

    def _latest_checkpoint_path(self, storage: str) -> Optional[str]:
        cands = sorted(
            (d for d in os.listdir(storage) if d.startswith("checkpoint_")),
            key=lambda d: int(d.split("_")[-1]),
        )
        return os.path.join(storage, cands[-1]) if cands else None

    def _fit_once(self, name: str, storage: str, latest_ckpt: Optional[str]) -> Result:
        sc = self.scaling_config
        n = sc.num_workers
        res = sc.worker_resources()
        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if res.get("GPU", 0) * n > have:
            # No fallback to the CPU: a GPU gang the cluster cannot hold
            # fails now instead of waiting out the placement.
            raise RuntimeError(
                f"{n} workers of {res} need {res['GPU'] * n:g} GPUs; the "
                f"cluster has {have:g}"
            )
        pg = placement_group(
            [sc.worker_resources() for _ in range(n)],
            strategy=sc.placement_strategy,
        )
        workers = []
        try:
            import secrets

            rdv_token = secrets.token_hex(4)
            worker_cls = ray_tpu_torch.remote(TrainWorker)
            for rank in range(n):
                workers.append(
                    worker_cls.options(
                        scheduling_strategy=PlacementGroupSchedulingStrategy(
                            placement_group=pg,
                            placement_group_bundle_index=rank,
                        ),
                        max_concurrency=2,
                        # The actor holds its whole bundle, so a GPU
                        # bundle gives it a GPU worker (its own card).
                        num_cpus=res.get("CPU", 0),
                        num_gpus=res.get("GPU", 0),
                        resources={
                            k: v for k, v in res.items()
                            if k not in ("CPU", "GPU")
                        },
                    ).remote(
                        rank, n, name, storage, sc.use_torch_distributed,
                        res.get("GPU", 0) > 0, rdv_token,
                    )
                )
            ray_tpu_torch.get([w.ping.remote() for w in workers], timeout=120)
            cfg = self._config
            if self.datasets:
                cfg = dict(cfg or {})
                cfg["__datasets__"] = self.datasets
            ray_tpu_torch.get(
                [w.run.remote(self._train_loop, cfg, latest_ckpt) for w in workers],
                timeout=120,
            )
            history = []
            final_metrics = None
            checkpoint = None
            iteration = 0
            while True:
                results = ray_tpu_torch.get(
                    [w.next_result.remote() for w in workers]
                )
                kinds = {r[0] for r in results}
                if "done" in kinds:
                    break
                iteration += 1
                rank0_kind, metrics, ckpt_path = results[0]
                final_metrics = metrics
                history.append(metrics)
                if ckpt_path:
                    persisted = os.path.join(storage, f"checkpoint_{iteration:06d}")
                    if os.path.abspath(ckpt_path) != persisted:
                        import shutil

                        shutil.copytree(ckpt_path, persisted, dirs_exist_ok=True)
                    checkpoint = Checkpoint(persisted)
                    self._prune_checkpoints(storage)
            return Result(
                metrics=final_metrics,
                checkpoint=checkpoint,
                error=None,
                path=storage,
                metrics_history=history,
            )
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
                    pass
            try:
                remove_placement_group(pg)
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
                pass

    def _prune_checkpoints(self, storage: str):
        keep = self.run_config.checkpoint_config.num_to_keep
        if not keep:
            return
        cands = sorted(
            (d for d in os.listdir(storage) if d.startswith("checkpoint_")),
            key=lambda d: int(d.split("_")[-1]),
        )
        import shutil

        for d in cands[:-keep]:
            shutil.rmtree(os.path.join(storage, d), ignore_errors=True)


def get_checkpoint() -> Optional[Checkpoint]:
    """Resume checkpoint for the current session (reference:
    train.get_checkpoint)."""
    s = get_session()
    if s is None:
        return None
    return getattr(s.context, "latest_checkpoint", None)
