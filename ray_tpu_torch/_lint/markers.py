"""`# raylint:` marker grammar.

One directive per marker comment, an optional reason after ` -- `:

    # raylint: <directive> [-- <reason>]

Directives:

``dispatch-only``
    The function runs on a dispatch/reader thread: it must not block
    (no-blocking-on-dispatch roots here) and must not touch guarded
    refcount/holder state or call into ``applier-only`` functions.

``applier-only``
    The function is part of the module's declared mutation domain for
    guarded refcount/holder state (the applier thread in the sharded
    directory; the under-``self._lock`` methods in the owner tracker).
    Only functions carrying this marker may mutate ``guarded-attrs``.

``disable=<rule>[,<rule>...] -- <reason>``
    Suppress the named rule(s) at this line (trailing comment) or for
    the whole function (comment on/above the ``def`` line). The reason
    is REQUIRED: a suppression without one is itself a violation
    (rule ``bare-suppression``).

``guarded-attrs=<name>[,<name>...]``
    Module-level (own-line comment): attribute names whose mutation is
    restricted to ``applier-only`` functions in this module.

``dispatch-handlers=<glob>[,<glob>...]``
    Module-level: function-name globs (fnmatch) treated as
    ``dispatch-only`` roots without per-function markers (e.g. the
    GCS's ``_h_*`` message handlers).

``check-event-literals``
    Module-level: ALL-CAPS string literals used in comparisons in this
    module must be registered flight-recorder event names (the
    timeline stitcher in ``state.py``).
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple

_MARKER_RE = re.compile(r"#\s*raylint:\s*(?P<body>.+?)\s*$")
_OWN_LINE_RE = re.compile(r"^\s*#")

#: Directives that only make sense at module scope (own-line comment).
MODULE_DIRECTIVES = (
    "guarded-attrs", "dispatch-handlers", "check-event-literals",
)

#: Function-domain directives (on/above a ``def`` line).
FUNCTION_DIRECTIVES = ("dispatch-only", "applier-only")


class Marker(NamedTuple):
    line: int            # 1-based source line the comment sits on
    own_line: bool       # comment is the whole line (module/next-def)
    directive: str       # e.g. "disable", "dispatch-only"
    value: str           # payload after "=", "" when none
    reason: str          # text after " -- ", "" when none

    @property
    def values(self) -> List[str]:
        return [v.strip() for v in self.value.split(",") if v.strip()]


def parse_markers(source: str) -> List[Marker]:
    """All `# raylint:` markers in the file, line-addressed.

    Comment scan is line-based (not tokenize): a ``# raylint:`` inside
    a string literal would misparse, but the grammar is unusual enough
    that the simplicity wins — fixture tests cover the real layouts.
    """
    out: List[Marker] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _MARKER_RE.search(text)
        if m is None:
            continue
        body = m.group("body")
        reason = ""
        if " -- " in body:
            body, reason = body.split(" -- ", 1)
            body = body.strip()
            reason = reason.strip()
        if "=" in body:
            directive, value = body.split("=", 1)
        else:
            directive, value = body, ""
        out.append(
            Marker(
                line=lineno,
                own_line=bool(_OWN_LINE_RE.match(text)),
                directive=directive.strip(),
                value=value.strip(),
                reason=reason,
            )
        )
    return out


def module_directives(markers: List[Marker]) -> Dict[str, List[str]]:
    """directive -> merged values, for module-scope directives."""
    out: Dict[str, List[str]] = {}
    for mk in markers:
        if mk.own_line and mk.directive in MODULE_DIRECTIVES:
            out.setdefault(mk.directive, []).extend(mk.values or [""])
    return out
