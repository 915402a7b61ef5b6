"""Per-file AST rules: the project invariants one file can prove alone.

The port's copy of ``kraken_tpu.lint.rules``: the same rules, the same
(rule, path, line, col) on the same source.

Each rule is a function ``(ctx: FileContext) -> list[Finding]``. Rules
are deliberately *syntactic* -- no type inference, no imports of the
linted code -- so the analyzer runs on any tree (including test
fixtures) in milliseconds and never executes what it checks. Where a
rule needs a heuristic (what "looks like" a thread lock), the heuristic
is written down next to the rule and the escape hatch is the reasoned
pragma, not a silent skip.

Cross-file rules (metric-catalog, failpoint-registry) live in
kraken_tpu_torch/lint/project.py.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from kraken_tpu_torch.lint.findings import Finding
from kraken_tpu_torch.lint.pragmas import PragmaInfo

# Every rule id the engine/pragmas accept. "pragma" and "parse-error"
# are meta-rules (emitted by the pragma parser / engine, suppressible
# never and nowhere); the rest map 1:1 to checker functions below or to
# project.py.
RULE_IDS = frozenset({
    "blocking-io-in-async",
    "fire-and-forget-task",
    "lock-across-await",
    "bare-except",
    "local-import-shadowing",
    "wall-clock-in-sim",
    "retry-without-deadline",
    "metric-catalog",
    "failpoint-registry",
    "pragma",
    "parse-error",
})


@dataclass
class FileContext:
    path: str          # project-root-relative, forward slashes
    source: str
    tree: ast.Module
    pragmas: PragmaInfo
    findings: list = field(default_factory=list)

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule, self.path, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0), message,
        ))


# -- shared AST helpers ----------------------------------------------------


def _dotted(func: ast.AST) -> str | None:
    """``a.b.c`` for an Attribute chain rooted at a Name, else None."""
    parts: list[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
        return ".".join(reversed(parts))
    return None


_FRAME_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_frame(body) -> list[ast.AST]:
    """Walk statements/expressions of one function frame WITHOUT
    descending into nested defs/lambdas (a nested sync def runs on its
    own schedule -- often off-loop -- and gets visited as its own
    frame)."""
    out: list[ast.AST] = []
    stack = [n for n in body if not isinstance(n, _FRAME_BOUNDARY)]
    while stack:
        node = stack.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FRAME_BOUNDARY):
                continue
            stack.append(child)
    return out


def _async_functions(tree: ast.Module):
    return [n for n in ast.walk(tree) if isinstance(n, ast.AsyncFunctionDef)]


# -- rule: blocking-io-in-async --------------------------------------------

# Sync calls that park the whole event loop (every conn pump, announce,
# and metrics scrape in the process) while they run. Route them through
# asyncio.to_thread / run_in_executor, or an off-loop helper.
_BLOCKING_NAMES = frozenset({"open"})
_BLOCKING_DOTTED = frozenset({
    "time.sleep",
    "os.fsync", "os.sync", "os.system",
    "sqlite3.connect",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "shutil.copyfile", "shutil.copytree", "shutil.rmtree",
    "socket.getaddrinfo", "socket.gethostbyname",
})


def check_blocking_io_in_async(ctx: FileContext) -> None:
    for fn in _async_functions(ctx.tree):
        for node in _walk_frame(fn.body):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Name) and node.func.id in _BLOCKING_NAMES:
                name = node.func.id
            else:
                dotted = _dotted(node.func)
                if dotted in _BLOCKING_DOTTED:
                    name = dotted
            if name:
                ctx.add(
                    "blocking-io-in-async", node,
                    f"sync `{name}(...)` inside `async def {fn.name}` parks"
                    " the event loop; route it through asyncio.to_thread /"
                    " run_in_executor (or an off-loop helper)",
                )


# -- rule: fire-and-forget-task --------------------------------------------


def _is_task_spawn(call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in ("create_task", "ensure_future")
    if isinstance(func, ast.Attribute):
        return func.attr in ("create_task", "ensure_future")
    return False


def check_fire_and_forget_task(ctx: FileContext) -> None:
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
            and _is_task_spawn(node.value)
        ):
            ctx.add(
                "fire-and-forget-task", node,
                "task spawned and dropped: asyncio keeps only a weak ref,"
                " so it can be GC'd mid-flight and its exception is"
                " swallowed -- retain the handle, track it in a set, or"
                " chain .add_done_callback(...)",
            )


# -- rule: lock-across-await -----------------------------------------------


def _looks_like_thread_lock(expr: ast.AST) -> str | None:
    """A sync `with X:` context that smells like a threading lock: a
    name/attr whose last segment contains "lock", or an inline
    threading.Lock()/RLock() call. (asyncio.Lock is taken with `async
    with`, so a *sync* with-block matching here is thread-lock shaped.)
    """
    if isinstance(expr, ast.Call):
        dotted = _dotted(expr.func)
        if dotted in ("threading.Lock", "threading.RLock"):
            return dotted
        return None
    last = None
    if isinstance(expr, ast.Attribute):
        last = expr.attr
    elif isinstance(expr, ast.Name):
        last = expr.id
    if last is not None and "lock" in last.lower():
        return last
    return None


def check_lock_across_await(ctx: FileContext) -> None:
    for fn in _async_functions(ctx.tree):
        for node in _walk_frame(fn.body):
            if not isinstance(node, ast.With):
                continue
            lock_name = None
            for item in node.items:
                lock_name = _looks_like_thread_lock(item.context_expr)
                if lock_name:
                    break
            if not lock_name:
                continue
            spans_await = any(
                isinstance(inner, (ast.Await, ast.AsyncFor, ast.AsyncWith))
                for inner in _walk_frame(node.body)
            )
            if spans_await:
                ctx.add(
                    "lock-across-await", node,
                    f"thread lock `{lock_name}` held across an await: every"
                    " other coroutine AND any sampler/worker thread wanting"
                    " it deadlocks against a parked frame -- narrow the"
                    " critical section or switch to asyncio.Lock",
                )


# -- rule: bare-except -----------------------------------------------------


def _is_broad_type(type_node: ast.AST | None) -> bool:
    if type_node is None:
        return True
    names = []
    if isinstance(type_node, ast.Tuple):
        names = [_dotted(e) or "" for e in type_node.elts]
    else:
        names = [_dotted(type_node) or ""]
    return any(n in ("Exception", "BaseException") for n in names)


def _body_is_silent(body) -> bool:
    """True when the handler neither raises, calls anything (no log, no
    counter), nor computes a fallback -- the error just vanishes."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


def check_bare_except(ctx: FileContext) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            ctx.add(
                "bare-except", node,
                "bare `except:` also catches SystemExit/KeyboardInterrupt"
                " and swallows the error unseen -- name the exception and"
                " count (FailureMeter) or log it",
            )
        elif _is_broad_type(node.type) and _body_is_silent(node.body):
            ctx.add(
                "bare-except", node,
                "`except Exception: pass` swallows every error with no"
                " counter or structured log -- the exact class the tracker"
                " `_metainfo` bug hid in; count, log, or narrow it",
            )


# -- rule: local-import-shadowing ------------------------------------------


def _import_bound_names(node) -> list[str]:
    names: list[str] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            names.append(alias.asname or alias.name.split(".", 1)[0])
    elif isinstance(node, ast.ImportFrom):
        for alias in node.names:
            if alias.name == "*":
                continue
            names.append(alias.asname or alias.name)
    return names


def check_local_import_shadowing(ctx: FileContext) -> None:
    # Module-scope imports: walk everything OUTSIDE function frames
    # (module body incl. try/if blocks; class bodies bind class attrs,
    # not module globals, so they are excluded along with functions).
    module_names: set[str] = set()
    stack = list(ctx.tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, _FRAME_BOUNDARY + (ast.ClassDef,)):
            continue
        module_names.update(_import_bound_names(node))
        stack.extend(ast.iter_child_nodes(node))
    if not module_names:
        return
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in _walk_frame(fn.body):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            shadowed = sorted(
                set(_import_bound_names(node)) & module_names
            )
            if shadowed:
                ctx.add(
                    "local-import-shadowing", node,
                    f"function-local import binds {shadowed} which shadows a"
                    f" module-level import: every earlier use of the name in"
                    f" `{fn.name}` becomes an UnboundLocalError (the cli.py"
                    " `import os` bug class) -- drop the local import or"
                    " alias it",
                )


# -- rule: wall-clock-in-sim -----------------------------------------------

_WALL_CLOCK = frozenset({
    "time.time", "time.monotonic", "time.perf_counter",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})


def _is_sim_file(ctx: FileContext) -> bool:
    return ctx.path.endswith("p2p/sim.py") or ctx.pragmas.sim_clocked


def check_wall_clock_in_sim(ctx: FileContext) -> None:
    if not _is_sim_file(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted in _WALL_CLOCK:
            ctx.add(
                "wall-clock-in-sim", node,
                f"`{dotted}()` in sim-clocked code: a 30k-agent run"
                " compresses hours into seconds, so wall-clock reads"
                " (timeouts, blacklists, TTLs) silently never expire --"
                " take the sim clock instead",
            )


# -- rule: retry-without-deadline ------------------------------------------

# Client-side RPC method names (origin BlobClient / ClusterClient,
# tracker clients, httputil) -- an await of one of these inside a loop
# is a retry/walk sweep. The heuristic is name-based (no type
# inference): a false positive on a same-named local helper takes a
# reasoned pragma, same as every other rule here.
_RPC_METHODS = frozenset({
    "stat", "download", "download_to_file",
    "upload", "upload_from_file", "upload_from_store",
    "get_metainfo", "get_recipe", "get_to_file",
    "request", "request_full", "announce", "adopt",
})


def _is_test_file(path: str) -> bool:
    parts = path.split("/")
    base = parts[-1]
    return (
        "tests" in parts[:-1]
        or base.startswith("test_")
        or base == "conftest.py"
    )


def _mentions_deadline(fn: ast.AST) -> bool:
    """Does ANY name/arg/attribute/keyword in the function smell like a
    deadline budget? Deliberately generous: the rule exists to catch
    loops with NO budget in sight, not to audit how the budget is
    threaded."""
    for node in ast.walk(fn):
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.arg):
            ident = node.arg
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        elif isinstance(node, ast.keyword):
            ident = node.arg
        if ident is not None and "deadline" in ident.lower():
            return True
    return False


def check_retry_without_deadline(ctx: FileContext) -> None:
    """A retry/walk loop issuing RPCs without a ``Deadline`` budget in
    scope retries forever at the caller's expense: N replicas x a full
    client timeout each, with the caller's own budget nowhere in the
    frame. The fix is one ``Deadline(...)`` created before the loop and
    threaded into every attempt (utils/deadline.py); loops that are
    LEGITIMATELY unbounded (a supervisor's forever-poll) take a
    reasoned pragma."""
    if _is_test_file(ctx.path):
        return  # tests drive retries deliberately; production only
    for fn in _async_functions(ctx.tree):
        if _mentions_deadline(fn):
            continue
        for loop in _walk_frame(fn.body):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for inner in _walk_frame(loop.body):
                if not (
                    isinstance(inner, ast.Await)
                    and isinstance(inner.value, ast.Call)
                    and isinstance(inner.value.func, ast.Attribute)
                    and inner.value.func.attr in _RPC_METHODS
                ):
                    continue
                ctx.add(
                    "retry-without-deadline", loop,
                    f"loop in `async def {fn.name}` awaits"
                    f" `.{inner.value.func.attr}(...)` with no Deadline"
                    " budget anywhere in the function: the sweep costs N"
                    " replicas x a full client timeout each -- create a"
                    " Deadline before the loop and pass it to every"
                    " attempt (utils/deadline.py)",
                )
                break  # one finding per loop, not per call site


FILE_RULES = (
    check_blocking_io_in_async,
    check_fire_and_forget_task,
    check_lock_across_await,
    check_bare_except,
    check_local_import_shadowing,
    check_wall_clock_in_sim,
    check_retry_without_deadline,
)
