"""Typed exceptions for library invariants.

Library code paths must not rely on bare ``assert`` statements: they are
stripped under ``python -O``, silently turning invariant violations into
wrong answers downstream.  The repo-rule analyzer
(`repro.analysis.repo_rules`, rule ``bare-assert``) enforces that every
invariant check in the pipeline packages raises one of these instead.
"""
from __future__ import annotations


class InvariantViolation(RuntimeError):
    """An internal structural invariant was broken.

    Raised where a bare ``assert`` used to live: the condition is not a
    user error but a bug in this library (or corrupted state fed back
    into it), and it must fail loudly even under ``python -O``.
    """


class ServiceUnavailable(RuntimeError):
    """Every tier of the serving degradation ladder failed for a batch.

    Raised by `repro.serve.query_server.QueryServer` only when the fused
    device path, the per-query fallback, the host reference engine AND
    the last-known-good cache all failed to produce an answer — the
    server is DOWN and says so instead of returning anything silently
    wrong.  The request may be retried: the ladder re-runs per batch
    and recovers as soon as any tier heals.
    """


def require(condition: bool, message: str) -> None:
    """``assert`` replacement that survives ``python -O``."""
    if not condition:
        raise InvariantViolation(message)
