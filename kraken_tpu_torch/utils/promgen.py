"""Generate the shipped Prometheus deployment from the SLO plane.

The port's copy of ``kraken_tpu.utils.promgen``. ``deploy/prometheus/`` is
generated, not hand-maintained: the scrape config enumerates the
components at their shipped ports (``config/*/base.yaml``), and the
burn-rate alert rules come from the same shipped ``SLOConfig`` defaults
the in-process evaluators run (``utils/slo.py``), so a knob change cannot
leave Prometheus paging on stale thresholds. The port writes the files
byte for byte as the reference does, the header included (it names the
reference's command, which writes the same bytes). Regenerate with
``python -m kraken_tpu_torch.cli promgen``.
"""

from __future__ import annotations

import os
import re

from kraken_tpu_torch.utils.slo import SLOConfig, format_window

# The shipped component listeners (config/<component>/base.yaml ports).
SHIPPED_TARGETS: tuple[tuple[str, int], ...] = (
    ("agent", 7601),
    ("tracker", 7602),
    ("origin", 7610),
    ("build-index", 7620),
    ("proxy", 7630),
)

_HEADER = """\
# GENERATED by `python -m kraken_tpu.cli promgen` -- do not edit by
# hand; edit kraken_tpu/utils/promgen.py (or the SLO defaults in
# kraken_tpu/utils/slo.py) and regenerate. tests/test_promgen.py gates
# drift.
"""


def generate_prometheus_config() -> str:
    """The scrape config: one job per component at its shipped port.
    Replace ``static_configs`` with your service discovery; the job
    names and the 15 s cadence match the alert rule windows."""
    lines = [
        _HEADER,
        "global:",
        "  scrape_interval: 15s",
        "  evaluation_interval: 15s",
        "",
        "rule_files:",
        "  - kraken-alerts.yml",
        "",
        "scrape_configs:",
    ]
    for component, port in SHIPPED_TARGETS:
        lines += [
            f"  - job_name: kraken-{component}",
            "    metrics_path: /metrics",
            "    static_configs:",
            f"      - targets: ['localhost:{port}']",
            "        labels:",
            f"          component: {component}",
        ]
    return "\n".join(lines) + "\n"


def _burn_expr(short_seconds: float, long_seconds: float,
               burn_rate: float) -> str:
    """The multi-window AND-condition, verbatim what the in-process
    evaluator computes -- the gauges already hold the windowed burn, so
    the rule is a plain threshold pair joined per (instance, sli)."""
    short_l, long_l = format_window(short_seconds), format_window(long_seconds)
    return (
        f'slo_burn_rate{{window="{short_l}"}} > {burn_rate}\n'
        f'          and on (instance, sli)\n'
        f'          slo_burn_rate{{window="{long_l}"}} > {burn_rate}'
    )


def _rules(cfg: SLOConfig) -> list[dict]:
    fast, slow = cfg.fast, cfg.slow
    return [
        {
            "alert": "KrakenSLOFastBurn",
            "expr": _burn_expr(
                fast.short_seconds, fast.long_seconds, fast.burn_rate
            ),
            "for": "2m",
            "severity": "page",
            "summary": (
                "error budget burning at >"
                f"{fast.burn_rate}x over both "
                f"{format_window(fast.short_seconds)} and "
                f"{format_window(fast.long_seconds)} for SLI "
                "{{ $labels.sli }} on {{ $labels.instance }}"
            ),
            "runbook": "docs/OPERATIONS.md#slo--canary",
        },
        {
            "alert": "KrakenSLOSlowBurn",
            "expr": _burn_expr(
                slow.short_seconds, slow.long_seconds, slow.burn_rate
            ),
            "for": "15m",
            "severity": "ticket",
            "summary": (
                "error budget burning at >"
                f"{slow.burn_rate}x over both "
                f"{format_window(slow.short_seconds)} and "
                f"{format_window(slow.long_seconds)} for SLI "
                "{{ $labels.sli }} on {{ $labels.instance }}"
            ),
            "runbook": "docs/OPERATIONS.md#slo--canary",
        },
        {
            # The node's OWN evaluator fired (it sees every event; a
            # scrape-gap cannot hide a page from this one).
            "alert": "KrakenSLOAlertFiring",
            "expr": 'max by (instance, sli, severity)'
                    ' (slo_alert_firing) > 0',
            "for": "1m",
            "severity": "page",
            "summary": "node-local burn-rate alert firing for SLI"
                       " {{ $labels.sli }} ({{ $labels.severity }})"
                       " on {{ $labels.instance }}",
            "runbook": "docs/OPERATIONS.md#slo--canary",
        },
        {
            "alert": "KrakenErrorBudgetExhausted",
            "expr": "slo_error_budget_remaining < 0",
            "for": "5m",
            "severity": "ticket",
            "summary": "error budget for SLI {{ $labels.sli }} exhausted"
                       " on {{ $labels.instance }} (burn already paged;"
                       " this tracks the debt)",
            "runbook": "docs/OPERATIONS.md#slo--canary",
        },
        {
            "alert": "KrakenCanaryFailing",
            "expr": 'increase(canary_probes_total{result!="ok"}[15m]) > 2',
            "for": "0m",
            "severity": "page",
            "summary": "synthetic canary probes failing"
                       " ({{ $labels.result }}) on {{ $labels.instance }}"
                       " -- the stack is broken even if no user noticed"
                       " yet",
            "runbook": "docs/OPERATIONS.md#slo--canary",
        },
        {
            "alert": "KrakenResourceBreach",
            "expr": "increase(resource_budget_breaches_total[10m]) > 0",
            "for": "0m",
            "severity": "ticket",
            "summary": "resource budget {{ $labels.kind }} breached on"
                       " {{ $labels.instance }} (see /debug/resources)",
            "runbook": "docs/OPERATIONS.md#resource-budgets-resources--the-in-process-sentinel",
        },
        {
            "alert": "KrakenNodeDraining",
            "expr": "max by (instance, component) (lameduck) > 0",
            "for": "10m",
            "severity": "ticket",
            "summary": "{{ $labels.component }} on {{ $labels.instance }}"
                       " draining for >10m -- a drain the deploy system"
                       " never finished",
            "runbook": "docs/OPERATIONS.md#degradation-plane-rpc--deadlines-breakers-hedges-lameduck",
        },
        {
            "alert": "KrakenWorkerCrashLoop",
            "expr": "increase(data_plane_worker_crashes_total[10m]) > 3",
            "for": "0m",
            "severity": "ticket",
            "summary": "data-plane worker shards crash-looping on"
                       " {{ $labels.instance }}",
            "runbook": "docs/OPERATIONS.md#data-plane-workers-scheduler-data_plane_workers--multi-core-serving",
        },
        {
            "alert": "KrakenAtRestCorruption",
            "expr": "increase(scrub_corruptions_total[1h]) > 0",
            "for": "0m",
            "severity": "ticket",
            "summary": "at-rest corruption quarantined on"
                       " {{ $labels.instance }} -- verify the heal"
                       " (blob_heals_total) and check the disk",
            "runbook": "docs/OPERATIONS.md#self-healing-storage-plane-fsck--scrub--quarantine",
        },
    ]


def generate_alert_rules(cfg: SLOConfig | None = None) -> str:
    cfg = cfg or SLOConfig()
    lines = [_HEADER, "groups:", "  - name: kraken-slo", "    rules:"]
    for rule in _rules(cfg):
        lines += [
            f"      - alert: {rule['alert']}",
            "        expr: |",
        ]
        for expr_line in rule["expr"].splitlines():
            lines.append(f"          {expr_line.strip()}")
        lines += [
            f"        for: {rule['for']}",
            "        labels:",
            f"          severity: {rule['severity']}",
            "        annotations:",
            f"          summary: \"{rule['summary']}\"",
            f"          runbook: \"{rule['runbook']}\"",
        ]
    return "\n".join(lines) + "\n"


_PROMQL_KEYWORDS = frozenset({
    "and", "or", "unless", "on", "by", "without", "ignoring",
    "group_left", "group_right", "increase", "rate", "irate", "max",
    "min", "sum", "avg", "count", "bool", "offset", "instance", "sli",
    "severity", "component", "window", "result", "kind", "job", "le",
    "m", "h", "s", "d",
})


def referenced_metric_names(rules_text: str) -> set[str]:
    """Every metric name the rule expressions reference -- the promgen
    CI gate checks each against the docs/OPERATIONS.md catalog (an
    alert over a metric nothing registers never fires)."""
    names: set[str] = set()
    # Expression lines sit at exactly 10 spaces under ``expr: |``; the
    # next mapping key (``for:``) sits at 8, which bounds the block.
    for m in re.finditer(r"expr: \|\n((?:[ ]{10}\S[^\n]*\n)+)", rules_text):
        expr = m.group(1)
        # Strip label matchers and durations, then collect identifiers.
        expr = re.sub(r"\{[^}]*\}", " ", expr)
        expr = re.sub(r"\[[^\]]*\]", " ", expr)
        for ident in re.findall(r"[a-zA-Z_][a-zA-Z0-9_]*", expr):
            if ident not in _PROMQL_KEYWORDS:
                names.add(ident)
    return names


def write_files(out_dir: str) -> list[str]:
    """Write both generated files; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for name, text in (
        ("prometheus.yml", generate_prometheus_config()),
        ("kraken-alerts.yml", generate_alert_rules()),
    ):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(text)
        out.append(path)
    return out
