"""The port's raylint: AST static analysis enforcing the runtime's
concurrency and reliability invariants (thread domains, one retry
policy, at-least-once GCS traffic, counted-never-silent faults, the
event-name registry), over ``ray_tpu_torch/`` with the port's own
``_private/event_names.py`` and ``baseline.json``.

Run from the repo root:

    python -m ray_tpu_torch._lint                   # check against the baseline
    python -m ray_tpu_torch._lint --write-baseline  # re-snapshot the debt
    python -m ray_tpu_torch._lint --only fixed-sleep-retry ray_tpu_torch/_private
    python -m ray_tpu_torch._lint --race            # the lock-witness race run

See ``markers.py`` for the ``# raylint:`` marker grammar and ``race.py``
for the race run.
"""
from .engine import (  # noqa: F401
    RULES,
    FileContext,
    Violation,
    diff_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    write_baseline,
)
from . import rules  # noqa: F401 - registers the rule catalogue
