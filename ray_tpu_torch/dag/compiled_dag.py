"""CompiledDAG: loop actors on pre-allocated channels.

Reference: python/ray/dag/compiled_dag_node.py — compiling an
actor-method DAG replaces per-call task RPC with single-slot
shared-memory channels (experimental_mutable_object_manager.cc) and a
resident loop in each actor: ~10x lower per-call overhead. Execution
becomes: write input channel → each actor reads its input channels,
runs its method, writes its output channel → read output channel.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import cloudpickle

from .._private.channel import Channel, ChannelClosed
from .dag_node import ClassMethodNode, DAGNode, InputNode


def _actor_loop(instance, method_name: str, in_specs, out_channel_name: str,
                const_args, const_kwargs):
    """Runs inside the actor (via __ray_apply__): read → call → write
    until the input channels close."""
    in_channels = [
        (pos, Channel(name)) for pos, name in in_specs
    ]
    out = Channel(out_channel_name)
    method = getattr(instance, method_name)
    try:
        while True:
            # Every channel carries ("ok", value) | ("err", exc) so an
            # upstream failure forwards through the pipeline to the
            # driver instead of poisoning a method call.
            args = list(const_args)
            upstream_err = None
            try:
                for pos, ch in in_channels:
                    status, payload = ch.read()
                    if status == "err":
                        upstream_err = payload
                    else:
                        args[pos] = payload
            except ChannelClosed:
                break
            if upstream_err is not None:
                out.write(("err", upstream_err))
                continue
            try:
                result = method(*args, **const_kwargs)
                out.write(("ok", result))
            except Exception as e:  # noqa: BLE001 - surface to caller
                out.write(("err", e))
    finally:
        out.close_writer()
        for _, ch in in_channels:
            ch.destroy()
        out.destroy()
    return "loop_done"


def _reject_nested_dag_nodes(value, where: str) -> None:
    """Compiled wiring only supports DAGNodes as top-level positional
    args; anything else would silently ship the node object as a
    constant. Fail loudly instead."""
    if isinstance(value, DAGNode):
        raise ValueError(
            f"CompiledDAG: DAGNode passed as {where}; compiled graphs "
            "support DAG inputs as top-level positional arguments only"
        )
    if isinstance(value, (list, tuple)):
        for v in value:
            _reject_nested_dag_nodes(v, where)
    elif isinstance(value, dict):
        for v in value.values():
            _reject_nested_dag_nodes(v, where)


class _CompiledStage:
    def __init__(self, node: ClassMethodNode):
        self.node = node
        self.in_specs: List = []  # (arg position, channel)
        self.out_channel: Optional[Channel] = None


class CompiledDAG:
    """Compile once, ``execute(input)`` many times. Supports linear and
    branching actor-method DAGs with a single InputNode and single
    output node."""

    def __init__(self, root: DAGNode, submit_timeout: float = 30.0):
        self._root = root
        self._timeout = submit_timeout
        self._stages: Dict[int, _CompiledStage] = {}
        self._input_channels: List[Channel] = []
        self._all_channels: List[Channel] = []  # driver owns/unlinks all
        self._output_channel: Optional[Channel] = None
        self._loop_refs = []
        self._destroyed = False
        self._inflight = 0
        # Guards _inflight for the feeder-thread/collector-thread
        # pipelining pattern (submit blocks on the bounded channels, so
        # keeping the pipe full needs a second thread).
        self._inflight_cv = threading.Condition()
        self._compile()

    # ------------------------------------------------------------ compile
    def _compile(self) -> None:
        order = self._root.topological_order()
        input_nodes = [n for n in order if isinstance(n, InputNode)]
        if len(input_nodes) > 1:
            raise ValueError("CompiledDAG supports exactly one InputNode")
        for node in order:
            if isinstance(node, InputNode):
                continue
            if not isinstance(node, ClassMethodNode):
                raise ValueError(
                    "CompiledDAG supports actor-method nodes only "
                    f"(got {type(node).__name__}); use .execute() for "
                    "task DAGs"
                )
            self._stages[id(node)] = _CompiledStage(node)

        # Wire channels: one per edge (fan-out gets one channel per
        # consumer since channels are SPSC).
        for node in order:
            if isinstance(node, InputNode):
                continue
            stage = self._stages[id(node)]
            const_args = []
            for pos, arg in enumerate(node._bound_args):
                if isinstance(arg, InputNode):
                    ch = Channel()
                    self._input_channels.append(ch)
                    self._all_channels.append(ch)
                    stage.in_specs.append((pos, ch))
                    const_args.append(None)
                elif isinstance(arg, DAGNode):
                    up = self._stages[id(arg)]
                    ch = Channel()
                    self._all_channels.append(ch)
                    if up.out_channel is not None:
                        raise ValueError(
                            "fan-out from one node to multiple consumers "
                            "is not yet supported in compiled mode"
                        )
                    up.out_channel = ch
                    stage.in_specs.append((pos, ch))
                    const_args.append(None)
                else:
                    _reject_nested_dag_nodes(arg, "positional arg")
                    const_args.append(arg)
            stage.const_args = const_args
            for k, v in node._bound_kwargs.items():
                _reject_nested_dag_nodes(v, f"kwarg {k!r}")
            stage.const_kwargs = dict(node._bound_kwargs)

        out_stage = self._stages[id(self._root)]
        self._output_channel = Channel()
        self._all_channels.append(self._output_channel)
        out_stage.out_channel = self._output_channel

        # Launch resident loops.
        for stage in self._stages.values():
            handle = stage.node.actor_handle
            loop_blob = cloudpickle.dumps(_actor_loop)
            ref = handle.__ray_apply__.remote(
                loop_blob,
                stage.node.method_name,
                [(pos, ch.name) for pos, ch in stage.in_specs],
                stage.out_channel.name,
                tuple(stage.const_args),
                stage.const_kwargs,
            )
            self._loop_refs.append(ref)

    # ------------------------------------------------------------ execute
    def _check_live(self) -> None:
        if self._destroyed:
            raise RuntimeError("CompiledDAG already torn down")
        if getattr(self, "_poisoned", False):
            raise RuntimeError(
                "CompiledDAG is poisoned: a previous operation timed out "
                "with a result still in flight (a later read would return "
                "the stale result). teardown() and re-compile."
            )

    def execute(self, *input_args) -> Any:
        self.submit(*input_args)
        return self.collect()

    def submit(self, *input_args) -> None:
        """Enqueue one input without waiting for its result — the
        pipelining half of execute() (reference: compiled-DAG
        execute() returns a future-like ref; here submit/collect split
        makes the microbatch pipeline explicit). Channels are
        single-slot, so total in-flight is bounded by the DAG's edge
        count: a submit into a full pipeline BLOCKS until a stage
        drains — natural backpressure. Results come out of collect()
        in submit order."""
        self._check_live()
        value = input_args[0] if len(input_args) == 1 else input_args
        try:
            for ch in self._input_channels:
                ch.write(("ok", value), timeout=self._timeout)
        except TimeoutError:
            self._poisoned = True
            raise
        with self._inflight_cv:
            self._inflight += 1
            self._inflight_cv.notify()

    def collect(self) -> Any:
        """Read the next result in submit (FIFO) order. With a feeder
        thread submitting concurrently, waits for the next submit to
        land rather than failing on the race."""
        self._check_live()
        with self._inflight_cv:
            # Grace window covers the feeder-thread race (submit is
            # microseconds from landing); a genuine collect-with-no-
            # submit still errors instead of parking self._timeout.
            if not self._inflight_cv.wait_for(
                lambda: self._inflight > 0, timeout=1.0
            ):
                raise RuntimeError("collect() without a matching submit()")
            self._inflight -= 1
        try:
            status, result = self._output_channel.read(timeout=self._timeout)
        except TimeoutError:
            self._poisoned = True
            raise
        if status == "err":
            raise result
        return result

    # ------------------------------------------------------------ teardown
    def teardown(self) -> None:
        if self._destroyed:
            return
        self._destroyed = True
        for ch in self._input_channels:
            ch.close_writer()
        import ray_tpu_torch

        for ref in self._loop_refs:
            try:
                ray_tpu_torch.get(ref, timeout=5.0)
            except Exception:  # noqa: BLE001
                pass
        for ch in self._all_channels:
            ch.destroy()

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # noqa: BLE001
            pass
