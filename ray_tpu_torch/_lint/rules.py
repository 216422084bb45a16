"""raylint rules: the runtime's concurrency & reliability invariants.

Each rule encodes an invariant the runtime already paid for:

- ``thread-domain`` — refcount/holder mutations happen only in the
  declared mutation domain (the sharded directory's single
  applier thread; the owner tracker's under-lock methods).
- ``no-blocking-on-dispatch`` — nothing reachable from a dispatch
  handler sleeps or does IO (background threads taxing the
  dispatch loop were measurable at storm rates).
- ``fixed-sleep-retry`` — retry loops ride ``chaos.Backoff`` /
  ``retry_call``, never a fixed ``time.sleep`` (one retry
  policy, full jitter, budgets).
- ``raw-send-on-gcs-path`` — GCS-routed completion/ref/submit traffic
  rides the at-least-once senders (the ``_report_done`` raw-send
  bug killed workers when a task completed mid-failover).
- ``swallowed-fault`` — a broad except either re-raises, records a
  flight-recorder event, logs, or counts; silent swallows hide
  ``ConnectionLost``/``SpillCorruptionError`` ("counted, never
  silent").
- ``event-taxonomy`` — every ``events.record()`` name and every
  timeline-stitch literal comes from the checked registry
  (``_private/event_names.py``), so ``state.py`` row stitching cannot
  silently miss renamed events.

Rules are pure AST passes over a :class:`~ray_tpu_torch._lint.engine.
FileContext`; each yields ``(line, message)`` pairs and the engine
applies ``disable=`` suppressions and the baseline.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, rule

# --------------------------------------------------------------- helpers


def _attr_chain(node: ast.AST) -> str:
    """Dotted name for simple attribute chains ("self.conn.send")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _contains(node: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(node))


def _enclosing(ctx: FileContext, node: ast.AST, kinds) -> Optional[ast.AST]:
    cur = ctx.parent.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = ctx.parent.get(cur)
    return None


_SET_MUTATORS = {
    "add", "discard", "remove", "clear", "update", "pop", "append",
    "extend", "popitem", "setdefault",
}


# ------------------------------------------------------------ thread-domain


@rule(
    "thread-domain",
    "guarded refcount/holder attrs mutate only in applier-only functions",
)
def thread_domain(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    guarded = set(ctx.module.get("guarded-attrs", []))
    if not guarded:
        return

    def guarded_attr(node: ast.AST) -> Optional[str]:
        # entry.holders / self._counts — the attribute itself.
        if isinstance(node, ast.Attribute) and node.attr in guarded:
            return node.attr
        return None

    def legal(line: int) -> bool:
        qual = ctx.enclosing_function(line)
        leaf = qual.rsplit(".", 1)[-1]
        if leaf == "__init__":
            return True  # construction precedes publication
        return ctx.function_has(qual, "applier-only")

    for node in ast.walk(ctx.tree):
        sites: List[Tuple[int, str]] = []
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                # entry.holders = ... / self._counts[oid] = ...
                base = t.value if isinstance(t, ast.Subscript) else t
                name = guarded_attr(base)
                if name:
                    sites.append((t.lineno, f"assignment to '{name}'"))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                name = guarded_attr(base)
                if name:
                    sites.append((node.lineno, f"del on '{name}'"))
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _SET_MUTATORS
            ):
                name = guarded_attr(f.value)
                if name:
                    sites.append(
                        (node.lineno, f"'{name}.{f.attr}()' mutation")
                    )
        for line, what in sites:
            if not legal(line):
                yield (
                    line,
                    f"{what} outside the applier domain — guarded attrs "
                    f"({', '.join(sorted(guarded))}) mutate only in "
                    f"'# raylint: applier-only' functions",
                )
    # Half two: dispatch-only functions must not call into the
    # applier domain (intra-module resolution).
    applier = {
        q for q in ctx.functions if ctx.function_has(q, "applier-only")
    }
    if not applier:
        return
    applier_leaves = {q.rsplit(".", 1)[-1] for q in applier}
    for root in ctx.dispatch_roots():
        fn = ctx.functions.get(root)
        if fn is None:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            # Nested defs are their own functions (usually thread
            # targets that do NOT run on the dispatch thread) — same
            # exclusion no-blocking-on-dispatch applies.
            if ctx.enclosing_function(node.lineno) != root:
                continue
            chain = _attr_chain(node.func)
            leaf = chain.rsplit(".", 1)[-1]
            if leaf in applier_leaves and (
                chain.startswith("self.") or chain == leaf
            ):
                yield (
                    node.lineno,
                    f"dispatch-only '{root}' calls applier-only "
                    f"'{leaf}'",
                )


# -------------------------------------------------- no-blocking-on-dispatch

#: Callable chains that block the calling thread.
_BLOCKING_CHAINS = {
    "time.sleep", "select.select", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
}
#: Method names that block regardless of receiver (socket reads,
#: Backoff.sleep, blocking joins on queues).
_BLOCKING_METHODS = {"sleep", "recv", "recvfrom", "recv_into", "accept"}


def _blocking_call(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name) and f.id == "open":
        return "open()"
    chain = _attr_chain(f)
    if chain in _BLOCKING_CHAINS:
        return chain + "()"
    if isinstance(f, ast.Attribute) and f.attr in _BLOCKING_METHODS:
        return chain + "()"
    return None


def _call_graph(ctx: FileContext) -> Dict[str, Set[str]]:
    """Intra-module edges: bare-name calls resolve to module functions,
    ``self.x()`` to a method of the same class."""
    edges: Dict[str, Set[str]] = {}
    leaf_index: Dict[str, List[str]] = {}
    for q in ctx.functions:
        leaf_index.setdefault(q.rsplit(".", 1)[-1], []).append(q)
    for qual, fn in ctx.functions.items():
        outs: Set[str] = set()
        cls_prefix = qual.rsplit(".", 1)[0] + "." if "." in qual else ""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                # Innermost scope first: a def nested in this function,
                # a sibling (shared enclosing scope), module level, or
                # — for closures passed around — a unique leaf match.
                name = f.id
                if qual + "." + name in ctx.functions:
                    outs.add(qual + "." + name)
                elif cls_prefix + name in ctx.functions:
                    outs.add(cls_prefix + name)
                elif name in ctx.functions:
                    outs.add(name)
                elif len(leaf_index.get(name, [])) == 1:
                    outs.add(leaf_index[name][0])
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and cls_prefix
                and cls_prefix + f.attr in ctx.functions
            ):
                outs.add(cls_prefix + f.attr)
        edges[qual] = outs
    return edges


@rule(
    "no-blocking-on-dispatch",
    "no sleep/IO/socket wait reachable from dispatch-thread handlers",
)
def no_blocking_on_dispatch(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    roots = ctx.dispatch_roots()
    if not roots:
        return
    edges = _call_graph(ctx)
    # BFS: function -> a root it is reachable from (for the message).
    via: Dict[str, str] = {}
    frontier = list(roots)
    for r in roots:
        via[r] = r
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in via:
                via[nxt] = via[cur]
                frontier.append(nxt)
    seen: Set[Tuple[int, str]] = set()
    for qual, root in via.items():
        fn = ctx.functions[qual]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            desc = _blocking_call(node)
            if desc is None:
                continue
            # Nested defs are indexed as their own functions: a worker
            # thread body defined inside a handler does not run on the
            # dispatch thread.
            if ctx.enclosing_function(node.lineno) != qual:
                continue
            key = (node.lineno, desc)
            if key in seen:
                continue
            seen.add(key)
            where = (
                f"dispatch handler '{qual}'" if qual == root
                else f"'{qual}' (reachable from dispatch handler "
                f"'{root}')"
            )
            yield (
                node.lineno,
                f"blocking call {desc} in {where}",
            )


# ------------------------------------------------------- fixed-sleep-retry


@rule(
    "fixed-sleep-retry",
    "retry-shaped time.sleep loops must ride chaos.Backoff/retry_call",
)
def fixed_sleep_retry(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _attr_chain(node.func) != "time.sleep":
            continue
        loop = _enclosing(ctx, node, (ast.While, ast.For))
        if loop is None:
            continue
        # Retry-shaped: the sleep IS the between-attempts delay — it
        # sits inside an except handler. (A sleep at the top of a loop
        # that merely contains a try is a poll cadence, not a retry.)
        handler = _enclosing(ctx, node, (ast.ExceptHandler,))
        if handler is None or handler.lineno < loop.lineno:
            continue
        # Already on the one retry policy? next_delay()/Backoff()/
        # retry_call anywhere in the loop exempts it.
        def on_policy(n: ast.AST) -> bool:
            if isinstance(n, ast.Attribute) and n.attr == "next_delay":
                return True
            if isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain.endswith("Backoff") or chain.endswith(
                    "retry_call"
                ) or chain.endswith(".sleep") and chain != "time.sleep":
                    return True
            return False

        if _contains(loop, on_policy):
            continue
        yield (
            node.lineno,
            "fixed time.sleep in a retry loop — use chaos.Backoff / "
            "chaos.retry_call (exp backoff + jitter + budget)",
        )


# ---------------------------------------------------- raw-send-on-gcs-path

#: Message types that MUST ride an at-least-once / failover-reliable
#: sender (send_reliable / request_reliable / the done-batcher / the
#: ref-flush tracker): completions, ref edges, submits, frees, puts.
RELIABLE_TYPES = {
    "submit_task", "task_done", "task_done_batch",
    "ref_flush", "update_refs", "free_objects", "put_object",
}

#: send attributes that are already reliable.
_RELIABLE_SENDERS = {"send_reliable", "request_reliable"}


def _dict_type_key(d: ast.AST) -> Optional[str]:
    if not isinstance(d, ast.Dict):
        return None
    for k, v in zip(d.keys, d.values):
        if (
            isinstance(k, ast.Constant) and k.value == "type"
            and isinstance(v, ast.Constant) and isinstance(v.value, str)
        ):
            return v.value
    return None


@rule(
    "raw-send-on-gcs-path",
    "GCS-routed completion/ref/submit traffic must use reliable senders",
)
def raw_send_on_gcs_path(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr in _RELIABLE_SENDERS or f.attr not in (
            "send", "request",
        ):
            continue
        arg = node.args[0]
        mtype = _dict_type_key(arg)
        if mtype is None and isinstance(arg, ast.Name):
            # Resolve `msg = {"type": ...}; conn.send(msg)` within the
            # same function (last literal assignment wins).
            qual = ctx.enclosing_function(node.lineno)
            fn = ctx.functions.get(qual)
            if fn is not None:
                for stmt in ast.walk(fn):
                    if (
                        isinstance(stmt, ast.Assign)
                        and stmt.lineno < node.lineno
                        and any(
                            isinstance(t, ast.Name) and t.id == arg.id
                            for t in stmt.targets
                        )
                    ):
                        got = _dict_type_key(stmt.value)
                        if got is not None:
                            mtype = got
        if mtype in RELIABLE_TYPES:
            yield (
                node.lineno,
                f"raw .{f.attr}() of '{mtype}' — this message class "
                "must ride send_reliable/request_reliable or an "
                "at-least-once batcher (the _report_done bug class)",
            )


# ---------------------------------------------------------- swallowed-fault

#: A handler that calls any of these is accounting for the fault.
_HANDLED_CALLS = {
    "record", "count_lost", "warning", "error", "exception", "critical",
    "debug", "info", "log", "print", "fail", "kill_point", "fault_point",
    "put_nowait", "set", "reply",
}
#: Assignments whose target mentions one of these count the fault.
_COUNTER_HINTS = re.compile(r"stats|drops|dropped|errors|lost|failed")


def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names: List[str] = []
    for n in ([t] if not isinstance(t, ast.Tuple) else t.elts):
        names.append(_attr_chain(n).rsplit(".", 1)[-1])
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_accounts(h: ast.ExceptHandler) -> bool:
    for n in ast.walk(h):
        if isinstance(n, ast.Raise):
            return True
        if (
            h.name is not None
            and isinstance(n, ast.Name)
            and n.id == h.name
            and isinstance(n.ctx, ast.Load)
        ):
            # `except Exception as e: ... e ...` — the fault is
            # CONVERTED (packed into an error blob, formatted into a
            # reply), not swallowed.
            return True
        if isinstance(n, ast.Call):
            f = n.func
            leaf = (
                f.attr if isinstance(f, ast.Attribute)
                else f.id if isinstance(f, ast.Name) else ""
            )
            if leaf in _HANDLED_CALLS:
                return True
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = (
                n.targets if isinstance(n, ast.Assign) else [n.target]
            )
            for t in targets:
                if _COUNTER_HINTS.search(ast.dump(t)):
                    return True
    return False


@rule(
    "swallowed-fault",
    "broad excepts must re-raise, record, log, or count — never swallow",
)
def swallowed_fault(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _broad_handler(node):
            continue
        if _handler_accounts(node):
            continue
        yield (
            node.lineno,
            "broad except swallows the fault — re-raise, record a "
            "flight-recorder event, log, or count it (ConnectionLost/"
            "SpillCorruptionError must never vanish)",
        )


# ----------------------------------------------------------- event-taxonomy

_REGISTRY_CACHE: Optional[Dict[str, Set[str]]] = None
#: The registry the event-taxonomy rule reads: the port's own.
EVENT_NAMES_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_private", "event_names.py",
)
_CAPS_RE = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")


def _load_registry() -> Dict[str, Set[str]]:
    """Exec the port's _private/event_names.py standalone (no package
    import: the lint must run without torch or the runtime loaded)."""
    global _REGISTRY_CACHE
    if _REGISTRY_CACHE is not None:
        return _REGISTRY_CACHE
    path = EVENT_NAMES_PATH
    ns: Dict[str, object] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            exec(compile(f.read(), path, "exec"), ns)  # noqa: S102
    except OSError:
        _REGISTRY_CACHE = {}
        return _REGISTRY_CACHE
    _REGISTRY_CACHE = {
        "events": set(ns.get("EVENT_NAMES", ())),
        "categories": set(ns.get("CATEGORIES", ())),
        "category_consts": set(ns.get("CATEGORY_CONSTS", ())),
        "task_table": set(ns.get("TASK_TABLE_EVENTS", ())),
    }
    return _REGISTRY_CACHE


@rule(
    "event-taxonomy",
    "events.record() names and timeline-stitch literals come from the "
    "event_names registry",
)
def event_taxonomy(ctx: FileContext) -> Iterator[Tuple[int, str]]:
    reg = _load_registry()
    if not reg:
        return
    events = reg["events"]
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (
            isinstance(f, ast.Attribute) and f.attr == "record"
            and len(node.args) >= 3
        ):
            continue
        cat, _entity, name = node.args[0], node.args[1], node.args[2]
        if isinstance(cat, ast.Constant) and isinstance(cat.value, str):
            if cat.value not in reg["categories"]:
                yield (
                    node.lineno,
                    f"unregistered event category '{cat.value}' — add "
                    "it to _private/event_names.py",
                )
        elif isinstance(cat, ast.Attribute):
            if (
                cat.attr not in reg["category_consts"]
                and _CAPS_RE.match(cat.attr)
            ):
                yield (
                    node.lineno,
                    f"unregistered category constant '{cat.attr}'",
                )
        if isinstance(name, ast.Constant) and isinstance(name.value, str):
            if name.value not in events:
                yield (
                    node.lineno,
                    f"unregistered event name '{name.value}' — add it "
                    "to _private/event_names.py so timeline stitching "
                    "and the state API can see it",
                )
    # Timeline-stitch literals (state.py opts in via module marker).
    if "check-event-literals" not in ctx.module:
        return
    known = events | reg["task_table"]
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Compare):
            continue
        consts: List[ast.Constant] = []
        for side in [node.left] + list(node.comparators):
            if isinstance(side, ast.Constant):
                consts.append(side)
            elif isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                consts.extend(
                    e for e in side.elts if isinstance(e, ast.Constant)
                )
        for c in consts:
            if (
                isinstance(c.value, str) and _CAPS_RE.match(c.value)
                and c.value not in known
            ):
                yield (
                    c.lineno,
                    f"timeline stitch references unregistered event "
                    f"name '{c.value}'",
                )
