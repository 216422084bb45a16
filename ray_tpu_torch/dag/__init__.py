"""ray_tpu_torch.dag: lazy DAGs of tasks and actor-method calls.

Reference: python/ray/dag/ (dag_node.py, input_node.py,
class_node.py, compiled_dag_node.py). ``fn.bind(...)`` builds the DAG
lazily; ``dag.execute(input)`` walks it with ordinary task submission;
``dag.experimental_compile()`` (actor-method DAGs) pre-allocates
channels and loops the actors on them, bypassing per-call RPC.
"""
from __future__ import annotations

from .dag_node import (  # noqa: F401
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
)
from .compiled_dag import CompiledDAG  # noqa: F401

__all__ = [
    "ClassMethodNode",
    "CompiledDAG",
    "DAGNode",
    "FunctionNode",
    "InputNode",
]
