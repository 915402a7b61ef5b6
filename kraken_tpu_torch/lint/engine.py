"""The analyzer driver: collect files, run rules, filter pragmas, emit.

The port's copy of ``kraken_tpu.lint.engine``.

Exit-code contract (the deploy/CI gate, matching the other offline
tools in cli.py): **0** clean, **1** findings, **3** usage error (no
paths / a named path does not exist -- the tree was never examined, so
neither "clean" nor "dirty").
"""

from __future__ import annotations

import ast
import json
import os

from kraken_tpu_torch.lint.findings import Finding
from kraken_tpu_torch.lint.pragmas import parse_pragmas
from kraken_tpu_torch.lint.project import PROJECT_RULES
from kraken_tpu_torch.lint.rules import FILE_RULES, RULE_IDS, FileContext

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
# Never suppressible: a broken pragma suppressing itself (or a file that
# does not parse "suppressing" its parse failure) would hide the very
# signal the gate exists for.
_UNSUPPRESSIBLE = {"pragma", "parse-error"}


class LintUsageError(Exception):
    """Bad invocation (exit 3): nothing was examined."""


def _collect_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            # An explicitly named non-.py file must error, not silently
            # drop: "files=0, findings=0, exit 0" would read as a clean
            # scan of a tree that was never examined. (Directory walks
            # below still filter to .py quietly -- that IS the scan.)
            if not p.endswith(".py"):
                raise LintUsageError(f"not a Python file: {p}")
            out.append(p)
            continue
        if not os.path.isdir(p):
            raise LintUsageError(f"no such file or directory: {p}")
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(set(out))


def find_project_root(start: str) -> str:
    """Walk up from the first linted path looking for the project
    markers the cross-file rules need (docs/OPERATIONS.md, or a .git
    top). Falls back to the start directory itself -- project rules
    then skip quietly (fixture subtrees)."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    probe = cur
    while True:
        if (
            os.path.isfile(os.path.join(probe, "docs", "OPERATIONS.md"))
            or os.path.isdir(os.path.join(probe, ".git"))
        ):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            return cur
        probe = parent


def lint_paths(
    paths: list[str], root: str | None = None
) -> tuple[list[Finding], dict]:
    """Run every rule over ``paths``. Returns (sorted findings, stats
    dict with ``files`` and ``suppressed``). Raises LintUsageError on a
    bad invocation."""
    if not paths:
        raise LintUsageError("lint requires at least one file or directory")
    files = _collect_files(paths)
    if root is None:
        root = find_project_root(paths[0])
    contexts: list[FileContext] = []
    findings: list[Finding] = []
    for abspath in files:
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            raise LintUsageError(f"unreadable: {abspath}: {e}") from None
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                "parse-error", rel, e.lineno or 1, (e.offset or 1) - 1,
                f"file does not parse: {e.msg}",
            ))
            continue
        ctx = FileContext(
            path=rel, source=source, tree=tree,
            pragmas=parse_pragmas(source, rel, RULE_IDS),
        )
        for rule in FILE_RULES:
            rule(ctx)
        findings.extend(ctx.findings)
        findings.extend(ctx.pragmas.findings)
        contexts.append(ctx)
    for project_rule in PROJECT_RULES:
        findings.extend(project_rule(contexts, root))
    pragma_by_path = {c.path: c.pragmas for c in contexts}
    kept: list[Finding] = []
    suppressed = 0
    for f in findings:
        info = pragma_by_path.get(f.path)
        if (
            f.rule not in _UNSUPPRESSIBLE
            and info is not None
            and info.suppresses(f.line, f.rule)
        ):
            suppressed += 1
            continue
        kept.append(f)
    kept.sort(key=Finding.sort_key)
    return kept, {"files": len(files), "suppressed": suppressed}


def run_lint_tool(paths: list[str], json_output: bool = False) -> int:
    """`kraken-tpu lint`: in-process callable for tests. Exit 0 clean /
    1 findings / 3 usage."""
    try:
        findings, stats = lint_paths(paths)
    except LintUsageError as e:
        print(json.dumps({"event": "error", "message": str(e)}), flush=True)
        return 3
    summary = {
        "event": "lint_done",
        "files": stats["files"],
        "findings": len(findings),
        "suppressed": stats["suppressed"],
    }
    if json_output:
        doc = dict(summary)
        doc["results"] = [f.to_dict() for f in findings]
        print(json.dumps(doc, indent=2), flush=True)
    else:
        for f in findings:
            print(f.render())
        print(json.dumps(summary), flush=True)
    return 1 if findings else 0
