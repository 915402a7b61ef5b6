"""Cross-file project rules: invariants no single file can prove.

The port's copy of ``kraken_tpu.lint.project``. The failpoint registry
is found by its suffix, so a scan of the port reads the port's
``utils/failpoints.py``; the metric catalog stays the project's
``docs/OPERATIONS.md``.

- ``metric-catalog``: every metric-name literal registered in production
  code appears (backtick-quoted) in docs/OPERATIONS.md, and every name
  in the "## Metric catalog" section's tables is registered somewhere in
  the scanned tree. Two-way: the catalog can neither lag the code nor
  accumulate stale rows. (tests/test_metric_catalog.py adds the runtime
  half -- names registered dynamically by a live agent+origin pair.)

- ``failpoint-registry``: every ``failpoints.fire("name")`` site uses a
  name declared exactly once in ``KNOWN_FAILPOINTS``
  (kraken_tpu_torch/utils/failpoints.py), and every declared name has at least
  one site. Closes the silent-typo hole: a fat-fingered
  ``KRAKEN_FAILPOINTS=trcker.announce.error=once`` chaos run used to run
  green while injecting nothing.

Both rules scan *production* files only (tests arm bad names and quote
bad code on purpose); both anchor their "completeness" direction on the
registry file being part of the scan, so linting a subtree never
false-flags the rest of the world as missing.
"""

from __future__ import annotations

import ast
import os
import re

from kraken_tpu_torch.lint.findings import Finding
from kraken_tpu_torch.lint.rules import FileContext, _dotted

# Metric names the catalog documents but no static literal registers
# (computed names). Keep this empty unless a name is genuinely dynamic;
# each entry needs the registering site in the comment.
_DYNAMIC_METRICS: frozenset = frozenset()

_METRIC_METHODS = ("counter", "gauge", "histogram")
_CATALOG_HEADING = "## Metric catalog"
_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)")


def is_cataloged(name: str, docs: str) -> bool:
    """THE containment contract, shared by this static rule and the
    runtime walk (tests/test_metric_catalog.py): a metric is cataloged
    when its exact name appears backtick-quoted anywhere in
    docs/OPERATIONS.md -- catalog tables and prose both count (the
    operator greps either way). The name must end at a non-identifier
    character (closing backtick, ``{labels}``, space): a bare prefix of
    some LONGER cataloged name must not count, or registering `pull`
    while the docs only know `pull_bytes_total` would pass the gate."""
    return re.search(
        r"`" + re.escape(name) + r"(?![a-z0-9_])", docs
    ) is not None


def _is_test_path(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    base = parts[-1]
    return (
        "tests" in parts[:-1]
        or base.startswith("test_")
        or base == "conftest.py"
    )


def _registered_metrics(files: list[FileContext]) -> dict[str, tuple]:
    """metric name -> (ctx, node) for every literal register call in
    production code."""
    out: dict[str, tuple] = {}
    for ctx in files:
        if _is_test_path(ctx.path):
            continue
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            func = node.func
            # REGISTRY.counter/gauge/histogram("name", ...) plus the
            # FailureMeter("name", ...) wrapper (counter + throttled
            # WARN) -- both mint a registry name from their first arg.
            is_register = (
                isinstance(func, ast.Attribute)
                and func.attr in _METRIC_METHODS
            ) or (
                (isinstance(func, ast.Name) and func.id == "FailureMeter")
                or (
                    isinstance(func, ast.Attribute)
                    and func.attr == "FailureMeter"
                )
            )
            if is_register:
                out.setdefault(node.args[0].value, (ctx, node))
    return out


def _catalog_names(docs: str) -> list[tuple[str, int]]:
    """(name, docs line) for every backticked token in the first cell of
    a "## Metric catalog" table row."""
    lines = docs.splitlines()
    out: list[tuple[str, int]] = []
    in_section = False
    for i, line in enumerate(lines, start=1):
        if line.startswith("## "):
            in_section = line.strip() == _CATALOG_HEADING
            continue
        if not in_section or not line.startswith("|"):
            continue
        first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
        # Label annotations -- `name` (labels `sli`, `window`) -- live
        # after the first paren; only what precedes it names metrics.
        first_cell = first_cell.split("(", 1)[0]
        for m in _NAME_RE.finditer(first_cell):
            out.append((m.group(1), i))
    return out


def check_metric_catalog(files: list[FileContext], root: str) -> list[Finding]:
    docs_path = os.path.join(root, "docs", "OPERATIONS.md")
    if not os.path.isfile(docs_path):
        return []  # not a project with a catalog (fixture subtrees)
    with open(docs_path, encoding="utf-8") as f:
        docs = f.read()
    findings: list[Finding] = []
    registered = _registered_metrics(files)
    for name, (ctx, node) in sorted(registered.items()):
        if not is_cataloged(name, docs):
            findings.append(Finding(
                "metric-catalog", ctx.path, node.lineno, node.col_offset,
                f"metric `{name}` is registered here but absent from the"
                " docs/OPERATIONS.md catalog -- add a row (the catalog is"
                " the operator's only index into the registry)",
            ))
    # Reverse direction only when the scan includes the registry module
    # itself -- the proxy for "the whole package is in view"; a subtree
    # lint must not flag every catalog row it cannot see the code for.
    full_scan = any(
        ctx.path.endswith("utils/metrics.py") for ctx in files
    )
    if full_scan:
        docs_rel = os.path.join("docs", "OPERATIONS.md").replace(os.sep, "/")
        for name, line in _catalog_names(docs):
            if name not in registered and name not in _DYNAMIC_METRICS:
                findings.append(Finding(
                    "metric-catalog", docs_rel, line, 0,
                    f"cataloged metric `{name}` is not registered anywhere"
                    " in the scanned tree -- stale row (or the register"
                    " site's name literal drifted)",
                ))
    return findings


# -- failpoint-registry ----------------------------------------------------

_REGISTRY_SUFFIX = "utils/failpoints.py"


def _parse_known_failpoints(ctx: FileContext):
    """(name -> lineno, duplicate findings) from the KNOWN_FAILPOINTS
    literal. Static parse -- fixtures need no importable package."""
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "KNOWN_FAILPOINTS"
                for t in node.targets
            )
        ):
            continue
        value = node.value
        if isinstance(value, ast.Call) and value.args:  # frozenset({...})
            value = value.args[0]
        elts = getattr(value, "elts", [])
        names: dict[str, int] = {}
        for elt in elts:
            if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
                continue
            if elt.value in names:
                findings.append(Finding(
                    "failpoint-registry", ctx.path, elt.lineno,
                    elt.col_offset,
                    f"failpoint `{elt.value}` declared more than once in"
                    " KNOWN_FAILPOINTS (declare each name exactly once)",
                ))
            else:
                names[elt.value] = elt.lineno
        return names, findings
    return None, findings


def _fire_sites(files: list[FileContext]) -> list[tuple]:
    """(name, ctx, node) for every literal fire("...") in production
    code outside the registry module itself."""
    out: list[tuple] = []
    for ctx in files:
        if _is_test_path(ctx.path) or ctx.path.endswith(_REGISTRY_SUFFIX):
            continue
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            func = node.func
            is_fire = (
                (isinstance(func, ast.Name) and func.id == "fire")
                or (isinstance(func, ast.Attribute) and func.attr == "fire")
            )
            if is_fire:
                out.append((node.args[0].value, ctx, node))
    return out


def check_failpoint_registry(files: list[FileContext], root: str) -> list[Finding]:
    registry_ctx = next(
        (c for c in files if c.path.endswith(_REGISTRY_SUFFIX)), None
    )
    sites = _fire_sites(files)
    if registry_ctx is None:
        return []  # subtree scan without the registry in view
    known, findings = _parse_known_failpoints(registry_ctx)
    if known is None:
        if sites:
            name, ctx, node = sites[0]
            findings.append(Finding(
                "failpoint-registry", registry_ctx.path, 1, 0,
                "no KNOWN_FAILPOINTS literal found in the registry module"
                f" but fire sites exist (first: `{name}` at {ctx.path}:"
                f"{node.lineno})",
            ))
        return findings
    used: set[str] = set()
    for name, ctx, node in sites:
        base = name.split("@", 1)[0]  # host-suffixed chaos variants
        used.add(base)
        if base not in known:
            findings.append(Finding(
                "failpoint-registry", ctx.path, node.lineno, node.col_offset,
                f"fire site `{name}` is not declared in KNOWN_FAILPOINTS"
                " (kraken_tpu_torch/utils/failpoints.py) -- declare it, or a"
                " typo'd KRAKEN_FAILPOINTS run injects nothing and still"
                " reports green",
            ))
    for name, line in sorted(known.items()):
        if name not in used:
            findings.append(Finding(
                "failpoint-registry", registry_ctx.path, line, 0,
                f"KNOWN_FAILPOINTS declares `{name}` but no fire(...) site"
                " uses it -- stale entry (or the site's literal drifted)",
            ))
    return findings


PROJECT_RULES = (check_metric_catalog, check_failpoint_registry)
