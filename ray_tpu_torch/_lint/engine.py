"""raylint engine: file contexts, rule registry, baseline workflow.

The engine parses each file once into a :class:`FileContext` (AST +
marker index + function table), runs every registered rule over it,
applies ``disable=`` suppressions, and diffs the surviving violations
against a JSON baseline: pre-existing debt is tracked, NEW violations
fail the run. ``--write-baseline`` re-snapshots the debt.

Fingerprints are line-number free — ``(rule, path, enclosing qualname,
stripped source text)`` — so unrelated edits moving a violation up or
down a file do not churn the baseline; only adding a second identical
violation to the same function trips the count.
"""
from __future__ import annotations

import ast
import fnmatch
import hashlib
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import markers as _markers

# --------------------------------------------------------------- registry

#: rule name -> (func, one-line doc). Populated by @rule.
RULES: Dict[str, Tuple[Callable, str]] = {}


def rule(name: str, doc: str):
    def deco(fn):
        RULES[name] = (fn, doc)
        return fn
    return deco


class Violation:
    __slots__ = ("rule", "path", "line", "message", "qualname", "text")

    def __init__(self, rule_name: str, path: str, line: int,
                 message: str, qualname: str, text: str):
        self.rule = rule_name
        self.path = path
        self.line = line
        self.message = message
        self.qualname = qualname
        self.text = text

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            "|".join((self.rule, self.path, self.qualname, self.text))
            .encode()
        )
        return h.hexdigest()[:16]

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        )

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "qualname": self.qualname,
            "fingerprint": self.fingerprint,
        }


# ---------------------------------------------------------- file context


class FileContext:
    """One parsed file: AST, markers, function table, parent links."""

    def __init__(self, path: str, source: str, repo_rel: str):
        self.path = repo_rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.markers = _markers.parse_markers(source)
        self.module = _markers.module_directives(self.markers)
        self._marker_by_line: Dict[int, List[_markers.Marker]] = {}
        for mk in self.markers:
            self._marker_by_line.setdefault(mk.line, []).append(mk)
        # Parent links (AST walk helpers).
        self.parent: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        # Function table: qualname -> def node, plus sorted spans for
        # enclosing-function lookup.
        self.functions: Dict[str, ast.AST] = {}
        self._spans: List[Tuple[int, int, str]] = []
        self._index_functions(self.tree, prefix="")
        self._spans.sort()
        # Function-scope directives (markers on decorator/def/above-def
        # lines): qualname -> list of markers.
        self.func_markers: Dict[str, List[_markers.Marker]] = {}
        for qual, node in self.functions.items():
            first = min(
                [node.lineno]
                + [d.lineno for d in getattr(node, "decorator_list", [])]
            )
            body_start = node.body[0].lineno if node.body else node.lineno
            mks: List[_markers.Marker] = []
            for ln in range(first - 1, body_start):
                mks.extend(self._marker_by_line.get(ln, []))
            self.func_markers[qual] = mks

    def _index_functions(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.functions[qual] = child
                self._spans.append(
                    (child.lineno, child.end_lineno or child.lineno, qual)
                )
                self._index_functions(child, prefix=f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                self._index_functions(child, prefix=f"{prefix}{child.name}.")
            else:
                self._index_functions(child, prefix=prefix)

    # ------------------------------------------------------------ lookups

    def enclosing_function(self, line: int) -> str:
        """Innermost function qualname containing the line; "<module>"
        otherwise."""
        best = "<module>"
        best_width = None
        for lo, hi, qual in self._spans:
            if lo <= line <= hi:
                width = hi - lo
                if best_width is None or width <= best_width:
                    best, best_width = qual, width
        return best

    def function_has(self, qual: str, directive: str) -> bool:
        for mk in self.func_markers.get(qual, []):
            if mk.directive == directive:
                return True
        # Nested defs inherit their parents' domain markers.
        while "." in qual:
            qual = qual.rsplit(".", 1)[0]
            for mk in self.func_markers.get(qual, []):
                if mk.directive == directive:
                    return True
        return False

    def dispatch_roots(self) -> List[str]:
        """Functions that run on dispatch threads: explicit
        ``dispatch-only`` markers plus module-level
        ``dispatch-handlers=`` globs."""
        # Direct markers only — a def nested inside a handler is most
        # often a thread target (Thread(target=...)) that does NOT run
        # on the dispatch thread; it joins the root set only if the
        # handler actually CALLS it (call-graph reachability).
        roots = [
            q for q in self.functions
            if any(
                mk.directive == "dispatch-only"
                for mk in self.func_markers.get(q, [])
            )
        ]
        globs = self.module.get("dispatch-handlers", [])
        if globs:
            for qual in self.functions:
                name = qual.rsplit(".", 1)[-1]
                if any(fnmatch.fnmatch(name, g) for g in globs):
                    roots.append(qual)
        return sorted(set(roots))

    def suppressed(self, rule_name: str, line: int) -> bool:
        """``disable=`` at the line, on an own-line comment just above
        it, or on the enclosing def."""
        candidates = list(self._marker_by_line.get(line, []))
        candidates.extend(
            mk for mk in self._marker_by_line.get(line - 1, [])
            if mk.own_line
        )
        qual = self.enclosing_function(line)
        while True:
            candidates.extend(self.func_markers.get(qual, []))
            if "." not in qual:
                break
            qual = qual.rsplit(".", 1)[0]
        for mk in candidates:
            if mk.directive == "disable" and rule_name in mk.values:
                return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


# ------------------------------------------------------------------ runner


def _iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [
                d for d in dirs
                if d not in ("__pycache__", ".git", "_native")
            ]
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(root, f))
    return out


def lint_source(source: str, path: str = "<string>",
                only: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint one source blob (fixture tests drive rules through this)."""
    ctx = FileContext(path, source, path)
    return _run_rules(ctx, only=only)


def lint_paths(paths: Iterable[str], repo_root: str,
               only: Optional[Iterable[str]] = None
               ) -> Tuple[List[Violation], List[str]]:
    """Lint a tree. Returns (violations, unparsable-file errors)."""
    violations: List[Violation] = []
    errors: List[str] = []
    for fp in _iter_py_files(paths):
        rel = os.path.relpath(fp, repo_root).replace(os.sep, "/")
        try:
            with open(fp, "r", encoding="utf-8") as f:
                source = f.read()
            ctx = FileContext(fp, source, rel)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {e}")
            continue
        violations.extend(_run_rules(ctx, only=only))
    return violations, errors


def _run_rules(ctx: FileContext,
               only: Optional[Iterable[str]] = None) -> List[Violation]:
    from . import rules as _rules  # noqa: F401 - registers RULES

    out: List[Violation] = []
    selected = set(only) if only else None
    for name, (fn, _doc) in sorted(RULES.items()):
        if selected is not None and name not in selected:
            continue
        for line, message in fn(ctx):
            if ctx.suppressed(name, line):
                continue
            out.append(
                Violation(
                    name, ctx.path, line, message,
                    ctx.enclosing_function(line), ctx.line_text(line),
                )
            )
    # Suppressions without a reason are themselves violations: a
    # disable marker is an auditable decision, not a mute button.
    for mk in ctx.markers:
        if mk.directive == "disable" and not mk.reason:
            out.append(
                Violation(
                    "bare-suppression", ctx.path, mk.line,
                    "disable marker without a ' -- reason'",
                    ctx.enclosing_function(mk.line),
                    ctx.line_text(mk.line),
                )
            )
    return out


# ---------------------------------------------------------------- baseline


def load_baseline(path: str) -> Dict[str, Dict]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return data.get("violations", {})


def write_baseline(path: str, violations: List[Violation]) -> None:
    table: Dict[str, Dict] = {}
    for v in sorted(violations, key=lambda v: (v.path, v.line)):
        rec = table.get(v.fingerprint)
        if rec is None:
            table[v.fingerprint] = {
                "rule": v.rule, "path": v.path, "qualname": v.qualname,
                "text": v.text, "count": 1,
            }
        else:
            rec["count"] += 1
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {"version": 1, "violations": table},
            f, indent=1, sort_keys=True,
        )
        f.write("\n")


def diff_baseline(
    violations: List[Violation], baseline: Dict[str, Dict]
) -> Tuple[List[Violation], List[str]]:
    """(new violations, fingerprints fixed since the baseline)."""
    counts: Dict[str, int] = {}
    new: List[Violation] = []
    for v in violations:
        fp = v.fingerprint
        counts[fp] = counts.get(fp, 0) + 1
        if counts[fp] > int(baseline.get(fp, {}).get("count", 0)):
            new.append(v)
    fixed = [fp for fp in baseline if fp not in counts]
    return new, fixed
