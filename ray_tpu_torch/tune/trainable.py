"""Trainables: the unit of work Tune runs, and the actor hosting it.

Reference: python/ray/tune/trainable/ — class API (trainable.py:
setup/step/save_checkpoint/load_checkpoint) and function API
(function_trainable.py: the loop calls tune.report). Both run inside a
``_TrialActor``; function trainables stream results through the same
session queue the Train workers use (one report contract across
libraries, as in the reference's AIR session).
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ..train.checkpoint import Checkpoint
from ..train.session import TrainContext, TrainSession, init_session


class Trainable:
    """Class API (reference: tune/trainable/trainable.py)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Reuse the instance for new hyperparams (PBT). Returning False
        forces a rebuild."""
        return False

    def cleanup(self) -> None:
        pass


@ray_tpu_torch.remote
class _TrialActor:
    """One actor per running trial (reference: Tune runs each trial as a
    remote Trainable actor via RayActorManager — SURVEY.md §2.4)."""

    def __init__(self, trial_id: str, local_dir: str):
        self.trial_id = trial_id
        self.local_dir = local_dir
        os.makedirs(local_dir, exist_ok=True)
        self.session: Optional[TrainSession] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._trainable: Optional[Trainable] = None
        self._ckpt_seq = 0

    # ------------------------------------------------------------- run

    def run(self, trainable, config: Dict[str, Any],
            checkpoint_path: Optional[str] = None,
            stop_criteria: Optional[Dict[str, Any]] = None) -> None:
        self.session = init_session(TrainContext(
            world_rank=0, world_size=1, local_rank=0, node_rank=0,
            experiment_name=self.trial_id, storage_path=self.local_dir,
        ))
        if checkpoint_path:
            self.session.context.latest_checkpoint = Checkpoint(checkpoint_path)
        self._stop_flag.clear()
        stop_criteria = stop_criteria or {}

        def runner():
            try:
                if isinstance(trainable, type) and issubclass(trainable, Trainable):
                    self._run_class(trainable, config, checkpoint_path,
                                    stop_criteria)
                else:
                    trainable(config)
                self.session.finish()
            except BaseException as e:  # noqa: BLE001
                traceback.print_exc()
                self.session.finish(error=e)

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def _run_class(self, cls, config, checkpoint_path, stop_criteria):
        t: Trainable = cls(config)
        self._trainable = t
        if checkpoint_path:
            t.load_checkpoint(checkpoint_path)
            # iteration restore: encoded in the checkpoint dir name
            base = os.path.basename(checkpoint_path.rstrip("/"))
            if base.startswith("checkpoint_"):
                t.iteration = int(base.split("_")[-1])
        max_iter = stop_criteria.get("training_iteration")
        while not self._stop_flag.is_set():
            result = t.step()
            t.iteration += 1
            result.setdefault("training_iteration", t.iteration)
            ckpt_dir = os.path.join(self.local_dir,
                                    f"checkpoint_{t.iteration:06d}")
            os.makedirs(ckpt_dir, exist_ok=True)
            saved = t.save_checkpoint(ckpt_dir)
            ckpt = Checkpoint(saved or ckpt_dir)
            self.session.report(result, checkpoint=ckpt)
            if result.get("done") or (max_iter and t.iteration >= max_iter):
                break
        t.cleanup()

    # ----------------------------------------------------------- polling

    def next_result(self, timeout: float = 10.0):
        """One (kind, payload) event: ("result", (metrics, ckpt_path)) |
        ("done", None) | ("error", exc) | ("timeout", None)."""
        import queue as _q

        try:
            item = self.session.next_result(timeout=timeout)
        except _q.Empty:
            return ("timeout", None)
        kind = item[0]
        if kind == "report":
            metrics, ckpt = item[1], item[2]
            path = ckpt.path if isinstance(ckpt, Checkpoint) else ckpt
            return ("result", (metrics, path))
        if kind == "done":
            err = self.session.error
            if err is not None:
                try:
                    import cloudpickle

                    cloudpickle.dumps(err)
                except Exception:
                    err = RuntimeError(str(err))
                return ("error", err)
            return ("done", None)
        return ("timeout", None)

    def stop(self) -> None:
        self._stop_flag.set()


def wrap_function(fn: Callable, extra: Dict[str, Any]) -> Callable:
    """tune.with_parameters (reference: tune/trainable/util.py)."""

    def wrapped(config):
        return fn(config, **extra)

    return wrapped
