"""Shared diagnostic record of the static-analysis subsystem (the
reference's ``repro.analysis.diagnostics``).

Every analysis leg reports findings as :class:`Diagnostic` rows so the CLI
can render them uniformly: ``<where>: <CODE> <message>``.  ``where`` is a
plan path (``plan.fwd.slot_nz``, ``plan.meta.l_pad``) for structural
findings.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a location, and a message."""

    code: str           # e.g. "P020"
    where: str          # file:line or plan path
    message: str

    def __str__(self) -> str:
        return f"{self.where}: {self.code} {self.message}"


def format_diagnostics(diags, *, header: str | None = None) -> str:
    """Render diagnostics one per line (with an optional header)."""
    lines = [] if header is None else [header]
    lines.extend(str(d) for d in diags)
    return "\n".join(lines)
