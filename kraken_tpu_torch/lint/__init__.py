"""kraken-lint: project-invariant static analysis.

The defect classes this repo keeps hand-fixing PR after PR -- blocking
IO on the event loop, stranded asyncio tasks, locks held across awaits,
bare excepts swallowing errors, local-import shadowing, wall-clock reads
in sim-time code, metric-catalog drift, failpoint-name typos -- are all
*machine-checkable*. This package encodes each as an AST (or cross-file
"project") rule. The port's copy of ``kraken_tpu.lint``: the same rules
and pragmas, and the same (rule, path, line, col) on the same source;
tests/test_torch_lint.py holds the port's tree at zero findings.

Entry points:

- ``python -m kraken_tpu_torch.cli lint kraken_tpu_torch/ [--json]`` -- the
  operator/CI surface (exit 0 clean / 1 findings / 3 usage).
- :func:`kraken_tpu_torch.lint.engine.lint_paths` -- the in-process API the
  gate test calls.

Suppressions are inline pragmas that REQUIRE a reason::

    risky_call()  # kt-lint: disable=<rule>  # <why this one is safe>

A pragma without a reason does not suppress anything and is itself a
finding (docs/TESTING.md "Static analysis tier").
"""

from kraken_tpu_torch.lint.engine import (  # noqa: F401
    Finding,
    LintUsageError,
    lint_paths,
    run_lint_tool,
)
from kraken_tpu_torch.lint.rules import RULE_IDS  # noqa: F401
