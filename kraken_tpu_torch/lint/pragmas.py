"""Inline suppression pragmas (and the sim-clocked file marker).

The port's copy of ``kraken_tpu.lint.pragmas``.

Grammar (a real COMMENT token -- pragma text inside a string literal is
inert, so test fixtures can quote bad pragmas without tripping the tree
gate)::

    # kt-lint: disable=<rule>[,<rule>...]  # <reason>

The reason is REQUIRED: a suppression nobody can explain in one clause
is a finding waiting to be rediscovered, so a reasonless pragma does not
suppress -- it becomes a ``pragma`` finding itself. Unknown rule names
are findings too (a typo'd pragma must not silently stop suppressing).

File marker::

    # kt-lint: sim-clocked

opts a file into the ``wall-clock-in-sim`` rule (sim-driven code paths
outside p2p/sim.py).
"""

from __future__ import annotations

import io
import re
import tokenize

from kraken_tpu_torch.lint.findings import Finding

_DISABLE_RE = re.compile(
    r"^#\s*kt-lint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:#\s*(\S.*))?$"
)
_MARKER_RE = re.compile(r"^#\s*kt-lint:\s*sim-clocked\s*$")
_ANY_KT_RE = re.compile(r"^#\s*kt-lint:")


class PragmaInfo:
    """Parsed pragma state for one file."""

    def __init__(self):
        # line (1-based) -> set of rule ids suppressed on that line
        self.suppressions: dict[int, set[str]] = {}
        self.findings: list[Finding] = []
        self.sim_clocked = False

    def suppresses(self, line: int, rule: str) -> bool:
        return rule in self.suppressions.get(line, ())


def parse_pragmas(source: str, path: str, known_rules: frozenset) -> PragmaInfo:
    info = PragmaInfo()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [
            (tok.start[0], tok.start[1], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        # The engine reports the parse failure; nothing to suppress.
        return info
    for line, col, text in comments:
        if _MARKER_RE.match(text):
            info.sim_clocked = True
            continue
        m = _DISABLE_RE.match(text)
        if m is None:
            if _ANY_KT_RE.match(text):
                info.findings.append(Finding(
                    "pragma", path, line, col,
                    f"unrecognized kt-lint pragma {text!r}; grammar:"
                    " `# kt-lint: disable=<rule>[,<rule>]  # <reason>`",
                ))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        unknown = sorted(r for r in rules if r not in known_rules)
        if unknown:
            info.findings.append(Finding(
                "pragma", path, line, col,
                f"pragma disables unknown rule(s) {unknown}; known:"
                f" {sorted(known_rules)}",
            ))
            rules -= set(unknown)
        if not reason:
            # No reason => no suppression: the pragma is the finding.
            info.findings.append(Finding(
                "pragma", path, line, col,
                "suppression pragma without a reason -- append"
                " `  # <why this site is safe>` or fix the finding",
            ))
            continue
        if rules:
            info.suppressions.setdefault(line, set()).update(rules)
    return info
