"""The one datatype every rule emits (the port's copy of
``kraken_tpu.lint.findings``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is relative to the lint invocation's project root (so gate
    output is stable across checkouts); ``line`` is 1-based, ``col``
    0-based (ast's convention, matching every editor's jump-to).
    """

    rule: str
    path: str
    line: int
    col: int
    message: str

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"
