"""DAG nodes (reference: python/ray/dag/dag_node.py).

A node captures (what to call, bound args) without executing. Args may
contain other DAGNodes — those become edges. ``execute`` memoizes per
node so diamond dependencies run once.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ------------------------------------------------------------ traverse
    def _upstream(self) -> List["DAGNode"]:
        out = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for v in self._bound_kwargs.values():
            scan(v)
        return out

    def topological_order(self) -> List["DAGNode"]:
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for up in node._upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order

    # ------------------------------------------------------------- execute
    def execute(self, *input_args, **input_kwargs):
        """Eagerly execute the DAG; returns the root's ObjectRef (or a
        plain value for InputNode roots)."""
        cache: Dict[int, Any] = {}
        for node in self.topological_order():
            cache[id(node)] = node._execute_node(cache, input_args, input_kwargs)
        return cache[id(self)]

    def _resolve_bound(self, cache: Dict[int, Any]):
        def sub(v):
            if isinstance(v, DAGNode):
                return cache[id(v)]
            if isinstance(v, list):
                return [sub(x) for x in v]
            if isinstance(v, tuple):
                return tuple(sub(x) for x in v)
            if isinstance(v, dict):
                return {k: sub(x) for k, x in v.items()}
            return v

        args = tuple(sub(a) for a in self._bound_args)
        kwargs = {k: sub(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_node(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self, **kwargs) -> "Any":
        from .compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """Placeholder for the value passed to ``execute``; supports
    context-manager syntax like the reference:

        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_node(self, cache, input_args, input_kwargs):
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        if not input_args and not input_kwargs:
            return None
        return (input_args, input_kwargs)


class FunctionNode(DAGNode):
    """A remote-function invocation node (fn.bind(...))."""

    def __init__(self, remote_function, args: tuple, kwargs: dict,
                 options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._fn = remote_function
        self._options = options or {}

    def _execute_node(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_bound(cache)
        fn = self._fn.options(**self._options) if self._options else self._fn
        return fn.remote(*args, **kwargs)

    @property
    def fn_name(self) -> str:
        return getattr(self._fn, "_name", None) or getattr(
            getattr(self._fn, "_fn", None), "__name__", "task"
        )


class ClassMethodNode(DAGNode):
    """An actor-method invocation node (actor.method.bind(...))."""

    def __init__(self, actor_method, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _execute_node(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_bound(cache)
        return self._method.remote(*args, **kwargs)

    @property
    def actor_handle(self):
        return self._method._handle

    @property
    def method_name(self) -> str:
        return self._method._method_name
