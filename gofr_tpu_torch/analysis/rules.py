"""gofrlint rules: the framework invariants, as AST lints (the port's
copy of ``gofr_tpu/analysis/rules.py``, its zone tables naming the port's
files and its device rules written for PyTorch on CUDA).

Rules
-----
``blocking-call``
    No blocking primitives (``time.sleep``, subprocess, sync socket/HTTP,
    sync ``open``) inside HTTP handler dispatch or the engine decode
    loop — those run on the event loop or the step thread, where one
    blocked millisecond is a missed decode step for every active slot.
    In retry/backoff paths (service client, pubsub reconnect, pool ping)
    only ``time.sleep`` is flagged: a sleep there must be an
    interruptible ``Event.wait`` so shutdown is never held hostage.
``host-sync``
    No host-device synchronization (``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``, and
    ``int()``/``float()``/``bool()`` or a truth test on a device tensor)
    on the engine thread's functions or in ``serving/batch.py`` except at
    the annotated sync points, ``serving/engine.py`` ``_block_sync`` and
    ``_first_token``. The pipelined decode reads the card ONCE per
    block; a second read serializes host and device again.
``metric-unregistered`` / ``metric-dynamic-name`` / ``metric-label-cardinality``
    Metric names used at call sites must be registered (the Manager
    silently drops unknown names — a typo loses the series, it does not
    crash), must be literals (dynamic names defeat registration), and
    label keys/values must be bounded (an f-string label value such as a
    request id explodes Prometheus cardinality).
``ctypes-unchecked``
    Every call into a kernel library's ctypes entries
    (``_build.library(name).gofr_*``) returns the launch's
    ``cudaError_t``; one that never reaches ``_build.check`` is flagged.
``daemon-loop-no-heartbeat``
    A ``while True`` loop running as a daemon-thread target must either
    check a stop ``Event`` or stamp a heartbeat — otherwise it can
    neither be shut down deliberately nor watched for hangs
    (``gofr_tpu_torch/testutil/`` scaffolding is exempt).
``pubsub-manual-settle``
    Subscriber handlers registered via ``app.subscribe(topic, handler)``
    are settled by the framework loop (commit on success, nack/DLQ on
    failure — subscriber.py). A handler that ALSO calls ``commit()``/
    ``nack()`` on its message rides on settle idempotency at best and
    fights the delivery policy at worst (a handler-committed message can
    no longer be nacked into the retry/DLQ ladder). Cross-file: handler
    registrations are collected everywhere, settle calls inside those
    functions are flagged.
``router-retry-untyped``
    The router's retry/failover paths (serving/router.py ``submit`` /
    ``_failover`` / ``_hedge``) may catch ONLY the typed-retriable error
    set (``RETRIABLE_ERRORS``: 503 warm-restart, 429 shed, breaker-open,
    chaos transient, transport reset) plus the terminal
    ``ErrorDeadlineExceeded``. A broad ``except Exception`` there would
    re-route requests that failed for non-retriable reasons — silently
    duplicating work, or worse, a non-idempotent stream.

Blocking/host-sync checks skip nested (closure) functions: closures in
these zones are deferred work — thread targets and
``run_in_executor`` payloads — which is exactly how blocking work is
*supposed* to leave the hot path.
"""

from __future__ import annotations

import ast

from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# -- zone tables --------------------------------------------------------------
# The reference's tables (gofr_tpu/analysis/rules.py:69-181) over the port's
# files. Dropped, for want of a port counterpart: serving/native_embed.py
# (libtpu's C API). The gRPC server's zone also covers the port's own HTTP/2
# wire (grpcx/h2.py), which runs on the same loop.

# event-loop / decode-thread dispatch surfaces: full blocking-call set.
# "*" = every function in the file; a set restricts to named functions.
DISPATCH_ZONES: dict[str, set[str] | str] = {
    "gofr_tpu_torch/http/dispatch.py": "*",
    "gofr_tpu_torch/http/server.py": "*",
    "gofr_tpu_torch/handler.py": "*",
    "gofr_tpu_torch/grpcx/server.py": "*",
    "gofr_tpu_torch/grpcx/h2.py": "*",
    "gofr_tpu_torch/websocket.py": "*",
    "gofr_tpu_torch/serving/handlers.py": "*",
    "gofr_tpu_torch/serving/engine.py": "*",
    "gofr_tpu_torch/serving/batch.py": "*",
    "gofr_tpu_torch/serving/stepplan.py": "*",
    "gofr_tpu_torch/serving/router.py": "*",
    # KV reuse tier: engine-thread-facing surfaces only — the spill
    # worker and the wire codec run off-thread BY DESIGN
    "gofr_tpu_torch/serving/kv_spill.py": {
        "get", "get_with_tier", "put", "peek", "evict", "_offer",
        "_to_device", "advertised",
    },
    "gofr_tpu_torch/serving/prefix_index.py": {
        "fetch_chain", "fetch_one", "fetch_handoff", "fetch_one_handoff",
        "evacuate_chain", "locate", "longest_chain", "observe",
    },
    # disaggregation plane: the autoscaler's control loop and the
    # remote-stream transport's event parsing
    "gofr_tpu_torch/serving/autoscaler.py": "*",
    "gofr_tpu_torch/serving/remote.py": "*",
    # multi-tenant and HA planes: submit/admission-path data structures
    "gofr_tpu_torch/serving/tenancy.py": "*",
    "gofr_tpu_torch/serving/dedup.py": "*",
    "gofr_tpu_torch/serving/lora.py": {
        "acquire", "release", "tables", "slot_factors", "prefetch",
        "register", "deregister", "known", "residency",
    },
}

# retry/backoff paths reachable from handlers: uninterruptible sleeps only
BACKOFF_ZONES: dict[str, set[str] | str] = {
    "gofr_tpu_torch/service/options.py": "*",
    "gofr_tpu_torch/pubsub/mqtt.py": "*",
    "gofr_tpu_torch/datasource/sql/pool.py": "*",
}

# router failover/hedge paths: except clauses here may name ONLY the
# typed-retriable set (plus the terminal deadline error)
ROUTER_RETRY_ZONES: dict[str, set[str] | str] = {
    "gofr_tpu_torch/serving/router.py": {
        "submit", "_submit_attempt", "_failover", "_hedge",
        "_submit_disagg", "_prefill_attempt", "_decode_phase",
        "_run_unary", "_run_stream", "resume", "_run_resume",
    },
}
ROUTER_RETRIABLE_NAMES = {
    "RETRIABLE_ERRORS",        # the canonical tuple (serving/router.py)
    "ErrorServiceUnavailable", "ErrorTooManyRequests",
    "CircuitBreakerError", "ChaosFault", "ConnectionError",
    "ErrorDeadlineExceeded",   # terminal: settles the request, never retried
    "ErrorStaleEpoch",         # fence rejection: router re-stamps and fails over
    "ErrorEntityNotFound",     # resume walk: replica doesn't hold the key — try the next
}

# decode hot path: the engine thread's functions and the dispatch module.
# The annotated sync points are engine.py's _block_sync (a block's packed
# result) and _first_token (a prefill's first token); nothing else may
# read the card from here.
HOT_SYNC_ZONES: dict[str, set[str] | str] = {
    "gofr_tpu_torch/serving/engine.py": {
        "_loop", "_loop_body", "_decode_step", "_spec_step",
        "_dispatch", "_dispatch_ragged", "_consume", "_observe_block",
        "_commit_token", "_commit_first_token", "_first_token", "_emit",
        "_block_sync", "_slot_in_flight", "_make_device_state",
        "_fold_admissions", "_retire", "_plan_step", "_cursor_health",
        "_cache_lookup", "_record_prefix_tier",
        "_maybe_preempt", "_preempt", "_lora_adjusted", "_lora_release",
    },
    "gofr_tpu_torch/serving/batch.py": "*",
    "gofr_tpu_torch/serving/stepplan.py": "*",
    "gofr_tpu_torch/serving/lora.py": {
        "acquire", "release", "tables", "slot_factors",
    },
    "gofr_tpu_torch/serving/kv_spill.py": {
        "get", "get_with_tier", "put", "peek", "_offer", "_to_device",
    },
    "gofr_tpu_torch/serving/prefix_index.py": {
        "fetch_chain", "fetch_one", "locate", "longest_chain",
    },
}

BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "os.system", "os.popen",
    "socket.create_connection",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.put", "requests.delete",
    "requests.request",
    "open",
}

SLEEP_CALLS = {"time.sleep"}

# PyTorch's host-device syncs: a device-wide wait, and the reads that copy
# a device tensor to the host (each waits for the stream to reach it)
HOST_SYNC_CALLS = {"torch.cuda.synchronize"}
HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# int()/float()/bool() on a DEVICE value, and its truth value in an if,
# while, assert, not/and/or or a conditional expression
# (Tensor.__bool__), is a hidden sync. An AST lint cannot type-infer, so
# taint heuristically: names assigned (incl. tuple unpacks) from calls
# rooted in these modules / with these terminal names produce device
# values, and so do calls on a device value (x.argmax()) and dotted names
# with a device-marker suffix. A .cpu()/.numpy()/.tolist()/.item() result
# is a HOST value — the read is the flagged sync itself.
DEVICE_PRODUCER_ROOTS = {"torch", "batch_ops", "llama"}
DEVICE_PRODUCER_NAMES = {"sample_logits", "prefill_compute"}
DEVICE_NAME_SUFFIXES = ("_dev", "_device")
HOST_CONVERT_CALLS = {"int", "float", "bool"}

# the port's kernel libraries: ``_build.library(name)`` hands out ctypes
# entries named gofr_*; each returns the cudaError_t of its launch
KERNEL_LIBRARY_CALLS = {"library", "_build.library"}
KERNEL_STATUS_CHECKS = {"check", "_build.check"}

METRIC_REGISTER_METHODS = {
    "new_counter", "new_updown_counter", "new_gauge", "new_histogram",
}
# the catalog table rows' kinds: ("counter", "app_x", "description", ...)
METRIC_CATALOG_KINDS = {"counter", "updown_counter", "gauge", "histogram"}
# the framework catalogs: the serving catalog and the container's own series
METRIC_CATALOG_FILES = ("serving/metrics_catalog.py", "container/container.py")
# method -> index of the first label argument (k, v alternating)
METRIC_USE_METHODS = {
    "increment_counter": 1,
    "delta_updown_counter": 2,
    "record_histogram": 2,
    "set_gauge": 2,
    "delete_gauge": 1,
}


def _dotted(node: ast.expr) -> str | None:
    """'time.sleep' for Name/Attribute chains; None for computed funcs."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _zone_functions(
    zones: dict[str, set[str] | str], rel_path: str
) -> set[str] | str | None:
    for suffix, funcs in zones.items():
        if rel_path.endswith(suffix):
            return funcs
    return None


class _FunctionCalls(ast.NodeVisitor):
    """Collect (call, enclosing-function-name, closure-depth) triples."""

    def __init__(self) -> None:
        self.calls: list[tuple[ast.Call, str | None, int]] = []
        self._stack: list[str] = []

    def _visit_func(self, node: ast.AST) -> None:
        self._stack.append(node.name)  # type: ignore[attr-defined]
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        name = self._stack[0] if self._stack else None
        self.calls.append((node, name, len(self._stack)))
        self.generic_visit(node)


class BlockingCallRule(Rule):
    name = "blocking-call"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        funcs = _zone_functions(DISPATCH_ZONES, sf.rel_path)
        flagged = BLOCKING_CALLS
        if funcs is None:
            funcs = _zone_functions(BACKOFF_ZONES, sf.rel_path)
            flagged = SLEEP_CALLS
        if funcs is None:
            return []
        visitor = _FunctionCalls()
        visitor.visit(sf.tree)
        out: list[Finding] = []
        for call, func_name, depth in visitor.calls:
            if depth > 1:  # closures are deferred work, off the hot path
                continue
            if funcs != "*" and func_name not in funcs:
                continue
            dotted = _dotted(call.func)
            if dotted in flagged:
                what = (
                    "uninterruptible sleep in a retry/backoff path — use an "
                    "Event.wait so close() can interrupt it"
                    if flagged is SLEEP_CALLS
                    else "blocking call in a handler-dispatch/decode-loop zone"
                )
                out.append(
                    Finding(self.name, sf.rel_path, call.lineno,
                            f"{dotted}(): {what}")
                )
        return out


class HostSyncRule(Rule):
    """``host-sync``: flags the explicit reads of a device tensor
    (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, a
    ``.synchronize()`` and ``torch.cuda.synchronize()``) AND the hidden
    ones — ``int()``/``float()``/``bool()`` on a device value, and its
    truth value (``Tensor.__bool__``) in ``if``/``while``/``assert``/
    ``not``/``and``/``or``/a conditional expression, block exactly like
    ``.item()`` does. Device values are tracked heuristically per
    function: names assigned from calls rooted in torch/batch_ops/llama
    (or known producer names like sample_logits), from calls on a device
    value, names copied from tainted names, and dotted names carrying a
    device-marker suffix (``_dev``, ``_device``). ``.shape``/``.dtype``-
    style metadata reads never taint, and an ``is``/``is not`` comparison
    is identity, never a read."""

    name = "host-sync"

    _BENIGN_META = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}

    def _tainted_names(self, func: ast.AST) -> set[str]:
        """Device-valued dotted names assigned inside ``func`` (top-level
        statements only — closures are deferred work, off the hot path).
        Two passes give one-hop propagation through local copies."""
        tainted: set[str] = set()

        def is_device_name(d: str | None) -> bool:
            return d is not None and (d in tainted or d.endswith(DEVICE_NAME_SUFFIXES))

        def value_is_device(expr: ast.expr) -> bool:
            if isinstance(expr, ast.Call):
                func = expr.func
                if isinstance(func, ast.Attribute) and func.attr in HOST_SYNC_METHODS:
                    return False  # a sync, flagged on its own; result is host
                if isinstance(func, ast.Attribute) and func.attr in self._BENIGN_META:
                    return False  # x.size() is host metadata
                d = _dotted(func) or ""
                if d == "torch.cuda.synchronize":
                    return False
                if (
                    d.split(".")[0] in DEVICE_PRODUCER_ROOTS
                    or d.split(".")[-1] in DEVICE_PRODUCER_NAMES
                ):
                    return True
                if isinstance(func, ast.Attribute):  # a method of a device value
                    return value_is_device(func.value)
                return False
            if isinstance(expr, ast.Subscript):
                return value_is_device(expr.value)
            if isinstance(expr, ast.Attribute) and expr.attr in self._BENIGN_META:
                return False
            if isinstance(expr, (ast.Name, ast.Attribute)):
                return is_device_name(_dotted(expr))
            if isinstance(expr, (ast.Tuple, ast.List)):
                return any(value_is_device(e) for e in expr.elts)
            if isinstance(expr, ast.BinOp):
                return value_is_device(expr.left) or value_is_device(expr.right)
            return False

        def scan(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(child, ast.Assign) and value_is_device(child.value):
                    targets: list[ast.expr] = list(child.targets)
                    while targets:
                        t = targets.pop()
                        if isinstance(t, (ast.Tuple, ast.List)):
                            targets.extend(t.elts)
                        else:
                            d = _dotted(t)
                            if d:
                                tainted.add(d)
                scan(child)

        scan(func)
        scan(func)  # second pass: one-hop propagation through copies
        return tainted

    def _expr_tainted(self, expr: ast.AST, tainted: set[str]) -> bool:
        """True when any (non-metadata) name inside ``expr`` is a device
        value."""
        hit = False

        def walk(n: ast.AST) -> None:
            nonlocal hit
            if hit:
                return
            if isinstance(n, ast.Attribute) and n.attr in self._BENIGN_META:
                return  # .shape/.dtype reads are static metadata, not syncs
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute) and f.attr in (
                    HOST_SYNC_METHODS | self._BENIGN_META
                ):
                    return  # already a host value (or metadata)
                if isinstance(f, ast.Name) and f.id in ("len", "isinstance"):
                    return  # len() of a tensor is its first dimension
            if isinstance(n, (ast.Name, ast.Attribute)):
                d = _dotted(n)
                if d is not None and (
                    d in tainted or d.endswith(DEVICE_NAME_SUFFIXES)
                ):
                    hit = True
                    return
            for child in ast.iter_child_nodes(n):
                walk(child)

        walk(expr)
        return hit

    def _truth_tainted(self, expr: ast.expr, tainted: set[str]) -> bool:
        """A truth test that calls ``Tensor.__bool__`` on a device value:
        the value itself, a subscript of it, or a comparison that yields a
        device tensor (``is``/``is not`` compare identity and never read)."""
        if isinstance(expr, ast.BoolOp):
            return any(self._truth_tainted(v, tainted) for v in expr.values)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            return self._truth_tainted(expr.operand, tainted)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
                return False
            return any(
                self._expr_tainted(e, tainted)
                for e in [expr.left, *expr.comparators]
            )
        if isinstance(expr, (ast.Name, ast.Attribute, ast.Subscript)):
            return self._expr_tainted(expr, tainted)
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Attribute) and func.attr not in (
                HOST_SYNC_METHODS | self._BENIGN_META
            ) and self._expr_tainted(func.value, tainted):
                return True  # x.any(), mask.all(): a device tensor's truth
            root = (_dotted(func) or "").split(".")[0]
            return root in DEVICE_PRODUCER_ROOTS and any(
                self._expr_tainted(a, tainted) for a in expr.args)  # torch.equal(a, b)
        return False

    @staticmethod
    def _truth_tests(func: ast.AST) -> list[ast.expr]:
        """Truth-tested expressions of ``func``'s own body (closures
        skipped, as everywhere in this rule)."""
        out: list[ast.expr] = []

        def scan(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(child, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                    out.append(child.test)
                elif isinstance(child, ast.comprehension):
                    out.extend(child.ifs)
                elif isinstance(child, ast.BoolOp):
                    out.extend(child.values)
                elif isinstance(child, ast.UnaryOp) and isinstance(child.op, ast.Not):
                    out.append(child.operand)
                scan(child)

        scan(func)
        return out

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        funcs = _zone_functions(HOT_SYNC_ZONES, sf.rel_path)
        if funcs is None:
            return []
        visitor = _FunctionCalls()
        visitor.visit(sf.tree)
        taint_cache: dict[str, set[str]] = {}
        func_nodes = {
            n.name: n
            for n in sf.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                for n in node.body:
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        func_nodes.setdefault(n.name, n)

        def taint_of(name: str) -> set[str]:
            if name not in taint_cache:
                taint_cache[name] = self._tainted_names(func_nodes[name])
            return taint_cache[name]

        out: list[Finding] = []
        for call, func_name, depth in visitor.calls:
            if depth > 1:
                continue
            if funcs != "*" and func_name not in funcs:
                continue
            dotted = _dotted(call.func)
            method = (
                call.func.attr if isinstance(call.func, ast.Attribute) else None
            )
            if dotted in HOST_SYNC_CALLS or method in HOST_SYNC_METHODS:
                out.append(
                    Finding(
                        self.name, sf.rel_path, call.lineno,
                        f"{dotted if dotted in HOST_SYNC_CALLS else '.' + str(method)}(): "
                        "host-device sync in the decode hot path — annotate "
                        "deliberate sync points with "
                        "'# gofrlint: disable=host-sync -- <why>'",
                    )
                )
                continue
            if dotted in HOST_CONVERT_CALLS and func_name in func_nodes:
                if call.args and self._expr_tainted(call.args[0], taint_of(func_name)):
                    out.append(
                        Finding(
                            self.name, sf.rel_path, call.lineno,
                            f"{dotted}() on a device value: a hidden "
                            "host-device sync in the decode hot path — read "
                            "it through the block's one sanctioned "
                            "materialization instead (or annotate with "
                            "'# gofrlint: disable=host-sync -- <why>')",
                        )
                    )
        for name, node in func_nodes.items():
            if funcs != "*" and name not in funcs:
                continue
            for test in self._truth_tests(node):
                if self._truth_tainted(test, taint_of(name)):
                    out.append(
                        Finding(
                            self.name, sf.rel_path, test.lineno,
                            "Tensor.__bool__ on a device value: a truth test "
                            "of a device tensor is a hidden host-device sync "
                            "in the decode hot path (or annotate with "
                            "'# gofrlint: disable=host-sync -- <why>')",
                        )
                    )
        return sorted(set(out), key=lambda f: (f.line, f.message))


class CtypesCheckedRule(Rule):
    """``ctypes-unchecked``: every call into a kernel library's entries
    (``_build.library(name).gofr_*(...)``, or an entry of a name bound to
    such a library) returns the launch's ``cudaError_t``; it must reach
    ``_build.check`` — passed directly, or bound to a name that a
    ``check`` call of the same function reads. A discarded status is a
    launch the CUDA runtime refused that nothing reports: a later
    synchronize does not."""

    name = "ctypes-unchecked"

    @staticmethod
    def _is_library_call(expr: ast.expr, libs: set[str]) -> bool:
        if isinstance(expr, ast.Call):
            return (_dotted(expr.func) or "") in KERNEL_LIBRARY_CALLS
        return isinstance(expr, ast.Name) and expr.id in libs

    def _check_function(self, sf: SourceFile, fn: ast.AST) -> list[Finding]:
        libs: set[str] = set()
        checked: set[str] = set()
        entries: list[tuple[ast.Call, ast.AST]] = []  # (entry call, parent)
        parents: dict[int, ast.AST] = {}
        for node in ast.walk(fn):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and (_dotted(node.value.func) or "") in KERNEL_LIBRARY_CALLS
            ):
                libs.add(node.targets[0].id)
            if isinstance(node, ast.Call) and (_dotted(node.func) or "") in KERNEL_STATUS_CHECKS:
                if node.args and isinstance(node.args[0], ast.Name):
                    checked.add(node.args[0].id)
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("gofr_")
                and self._is_library_call(node.func.value, libs)
            ):
                entries.append((node, parents.get(id(node), fn)))
        out: list[Finding] = []
        for call, parent in entries:
            ok = False
            if isinstance(parent, ast.Call) and (_dotted(parent.func) or "") in KERNEL_STATUS_CHECKS:
                ok = bool(parent.args) and parent.args[0] is call
            elif (
                isinstance(parent, ast.Assign) and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)
            ):
                ok = parent.targets[0].id in checked
            elif isinstance(parent, ast.Return):
                ok = True  # the caller owns the status
            if not ok:
                out.append(
                    Finding(
                        self.name, sf.rel_path, call.lineno,
                        f"{call.func.attr}(): kernel launch status discarded "  # type: ignore[attr-defined]
                        "— pass it to _build.check() (a launch the CUDA "
                        "runtime refused never ran, and a later synchronize "
                        "would not report it)",
                    )
                )
        return out

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function(sf, node))
        return sorted(set(out), key=lambda f: f.line)


class MetricsRule(Rule):
    """Cross-file: registrations collected everywhere, usages checked in
    finalize. Dynamic names / unbounded labels are flagged in place.

    Beyond never-registered names (``metric-unregistered`` — the Manager
    silently drops them), full-tree runs enforce the REGISTRATION SITE
    (``metric-register-site``): a name used anywhere in ``gofr_tpu_torch/``
    must be registered in a framework catalog (``serving/metrics_catalog.py``
    or ``container/container.py``, whose table rows count as registrations)
    or in the using file's own directory (self-registering subsystems:
    datasource drivers). Registration at an arbitrary distance means the
    series silently vanishes in any process that never imports the
    registering module. Only enforced when a catalog file is part of the
    scanned tree, so file-subset runs and fixture trees are unaffected."""

    name = "metric-unregistered"
    cross_file = True

    def __init__(self) -> None:
        self._registered: set[str] = set()
        self._register_sites: dict[str, set[str]] = {}  # name -> rel paths
        # name -> first container-catalog registration (path, line): the
        # anchor for the inverse metric-never-emitted finding
        self._catalog_lines: dict[str, tuple[str, int]] = {}
        self._container_seen = False
        self._usages: list[tuple[str, str, int]] = []  # (name, path, line)
        # names wired to a callback gauge: `g = m.get("name")` +
        # `g.observe_with(...)` — emitted every scrape, no .set site
        self._observed: set[str] = set()

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        in_container = sf.rel_path.endswith(METRIC_CATALOG_FILES)
        if in_container:
            self._container_seen = True
            self._catalog_rows(sf)
        inline: list[Finding] = []
        # (scope, var) -> metric name from `var = m.get("x")`, joined
        # against observe_with receivers AFTER the walk (ast order does
        # not guarantee the Assign is visited first). Keyed per
        # enclosing function: two callback gauges wired through the
        # same idiomatic local name (`g`) in different functions must
        # not collide
        get_bound: dict[tuple[int, str], str] = {}
        observe_vars: set[tuple[int, str]] = set()

        def scoped_nodes(root, scope):
            for child in ast.iter_child_nodes(root):
                child_scope = (
                    id(child)
                    if isinstance(
                        child,
                        (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                    )
                    else scope
                )
                yield child, child_scope
                yield from scoped_nodes(child, child_scope)

        for node, scope in scoped_nodes(sf.tree, 0):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "get"
                and node.value.args
                and isinstance(node.value.args[0], ast.Constant)
                and isinstance(node.value.args[0].value, str)
            ):
                get_bound[(scope, node.targets[0].id)] = (
                    node.value.args[0].value
                )
                continue
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            method = node.func.attr
            if method in METRIC_REGISTER_METHODS and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and isinstance(first.value, str):
                    self._registered.add(first.value)
                    self._register_sites.setdefault(first.value, set()).add(
                        sf.rel_path
                    )
                    if in_container:
                        self._catalog_lines.setdefault(
                            first.value, (sf.rel_path, node.lineno)
                        )
            elif method in METRIC_USE_METHODS:
                inline.extend(
                    self._check_usage(sf, node, METRIC_USE_METHODS[method])
                )
            elif method == "observe_with":
                recv = node.func.value
                if isinstance(recv, ast.Name):
                    observe_vars.add((scope, recv.id))
                elif isinstance(recv, ast.Call):
                    # chained m.get("x").observe_with(...)
                    f = recv.func
                    args = recv.args
                    if (
                        isinstance(f, ast.Attribute) and f.attr == "get"
                        and args
                        and isinstance(args[0], ast.Constant)
                        and isinstance(args[0].value, str)
                    ):
                        self._observed.add(args[0].value)
        for key in observe_vars:
            name = get_bound.get(key)
            if name is not None:
                self._observed.add(name)
        return [f for f in inline if not sf.is_suppressed(f.rule, f.line)]

    def _catalog_rows(self, sf: SourceFile) -> None:
        """The port registers its catalogs from tables of rows
        ``("kind", "app_name", "description", ...)`` looped over
        ``new_<kind>`` (serving/metrics_catalog.py SERVING_METRICS,
        container/container.py FRAMEWORK_METRICS): each row is a
        registration at its own line."""
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Tuple) or len(node.elts) < 2:
                continue
            kind, name = node.elts[0], node.elts[1]
            if (
                isinstance(kind, ast.Constant) and kind.value in METRIC_CATALOG_KINDS
                and isinstance(name, ast.Constant) and isinstance(name.value, str)
            ):
                self._registered.add(name.value)
                self._register_sites.setdefault(name.value, set()).add(sf.rel_path)
                self._catalog_lines.setdefault(name.value, (sf.rel_path, node.lineno))

    @staticmethod
    def _unbounded_value(expr: ast.expr) -> bool:
        """True for label-value expressions that smell unbounded: any
        string-building form — f-strings, ``+``/``%`` concatenation,
        ``.format()``/``.join()`` calls. A bare Name may be a bounded
        enum, so it stays clean; building a string at the call site is
        the per-request-id pattern that explodes series cardinality."""
        if isinstance(expr, (ast.JoinedStr, ast.BinOp)):
            return True
        return (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in ("format", "join")
        )

    def _check_usage(
        self, sf: SourceFile, node: ast.Call, label_start: int
    ) -> list[Finding]:
        out: list[Finding] = []
        if not node.args:
            return out
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            self._usages.append((first.value, sf.rel_path, node.lineno))
        elif isinstance(first, (ast.JoinedStr, ast.BinOp, ast.Call)):
            out.append(
                Finding(
                    "metric-dynamic-name", sf.rel_path, node.lineno,
                    "computed metric name defeats registration checking — "
                    "use a literal (or a variable bound to one)",
                )
            )
        labels = node.args[label_start:]
        for i, arg in enumerate(labels):
            if i % 2 == 0:  # label KEY
                if not (
                    isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                ) and not isinstance(arg, ast.Starred):
                    out.append(
                        Finding(
                            "metric-label-cardinality", sf.rel_path, arg.lineno,
                            "label KEY must be a string literal",
                        )
                    )
            elif self._unbounded_value(arg):
                out.append(
                    Finding(
                        "metric-label-cardinality", sf.rel_path, arg.lineno,
                        "computed label value — unbounded label cardinality "
                        "(per-request values explode the series space)",
                    )
                )
        for kw in node.keywords:
            if kw.arg is not None and self._unbounded_value(kw.value):
                out.append(
                    Finding(
                        "metric-label-cardinality", sf.rel_path, kw.value.lineno,
                        f"computed value for label '{kw.arg}' — unbounded "
                        "label cardinality",
                    )
                )
        return out

    def finalize(self) -> list[Finding]:
        import posixpath

        out: list[Finding] = []
        # the inverse rule (full-tree runs only, mirrors
        # metric-register-site): a name in the container catalog with
        # zero emission sites tree-wide — no .increment/.set/.record
        # call, no observe_with-wired callback gauge — is a dead series
        # every deployment registers and nobody ever feeds
        if self._container_seen:
            used_names = {name for name, _p, _l in self._usages}
            for name, (path, line) in sorted(self._catalog_lines.items()):
                if name in used_names or name in self._observed:
                    continue
                out.append(
                    Finding(
                        "metric-never-emitted", path, line,
                        f"metric '{name}' is registered in the framework "
                        "catalog but has zero emission sites tree-wide "
                        "(no increment/set/record call, no observe_with "
                        "wiring) — a dead series; delete the "
                        "registration or wire the emitter",
                    )
                )
        for name, path, line in self._usages:
            if name not in self._registered:
                out.append(
                    Finding(
                        "metric-unregistered", path, line,
                        f"metric '{name}' is never registered — the Manager "
                        "silently drops it (typo loses the series)",
                    )
                )
                continue
            if not self._container_seen:
                continue  # file-subset / fixture run: site check is moot
            sites = self._register_sites.get(name, set())
            use_dir = posixpath.dirname(path)
            if not any(
                site.endswith(METRIC_CATALOG_FILES)
                or posixpath.dirname(site) == use_dir
                for site in sites
            ):
                out.append(
                    Finding(
                        "metric-register-site", path, line,
                        f"metric '{name}' is registered only in "
                        f"{sorted(sites)} — register it in container/"
                        "container.py (the framework catalog) or in this "
                        "file's own subsystem: a process that never imports "
                        "the registering module silently loses the series",
                    )
                )
        return out


class DaemonLoopHeartbeatRule(Rule):
    """``daemon-loop-no-heartbeat``: a ``while True`` loop running on a
    daemon thread must either check a stop ``Event`` (``.wait()`` /
    ``.is_set()``) or stamp a heartbeat. A daemon loop with neither is
    invisible: it cannot be shut down deliberately, and when it hangs
    nothing — no supervisor, no watchdog — can tell. The engine loop and
    the supervisor watchdog are the template (serving/engine.py stamps
    ``self.heartbeat`` per iteration; supervisor.py gates on
    ``self._stop.wait``).

    Matching is per-file: ``threading.Thread(target=<fn>, daemon=True)``
    registrations are collected, and ``while True:`` loops inside
    same-file functions of that name are checked — ``self.<m>`` targets
    scope to the registering class, so a sibling class's same-named
    method is not cross-flagged. A ``.wait()``/
    ``.is_set()`` counts only when its receiver is recognizably a
    lifecycle event (name contains stop/shutdown/halt/...): a throttling
    ``self._wake.wait(0.05)`` leaves the loop exactly as unstoppable as
    no wait at all. ``gofr_tpu_torch/testutil/`` is exempt — test scaffolding
    threads live exactly as long as the process by design."""

    name = "daemon-loop-no-heartbeat"

    _STOP_METHODS = {"wait", "is_set"}
    # a .wait()/.is_set() only counts as supervision when its receiver is
    # recognizably a LIFECYCLE event: `self._wake.wait(0.05)` is a
    # throttle, not a stop check — a loop gated on nothing but that is
    # still unstoppable and unwatchable, the exact defect this rule exists
    # to flag
    _STOP_NAME_TOKENS = (
        "stop", "shutdown", "shut_down", "halt", "quit", "exit", "done",
        "closed", "closing", "cancel", "term", "finished",
    )

    @staticmethod
    def _target_name(node: ast.expr) -> str | None:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr  # self._loop → "_loop"
        return None

    @staticmethod
    def _scoped_walk(tree: ast.AST):
        """Yield (node, enclosing ClassDef | None) over the whole tree."""

        def walk(node: ast.AST, cls: ast.ClassDef | None):
            for child in ast.iter_child_nodes(node):
                child_cls = child if isinstance(child, ast.ClassDef) else cls
                yield child, child_cls
                yield from walk(child, child_cls)

        yield from walk(tree, None)

    def _daemon_targets(
        self, tree: ast.AST
    ) -> tuple[set[str], dict[int, set[str]]]:
        """Collect daemon-thread target names. ``self.<m>`` registrations
        scope to their enclosing class — an unrelated same-named method of
        a sibling class in the same file must not be flagged (same
        rationale as use-after-donation's scope-awareness). Plain-name and
        non-self attribute targets stay file-wide."""
        loose: set[str] = set()
        by_class: dict[int, set[str]] = {}
        for node, cls in self._scoped_walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func) or ""
            if not dotted.split(".")[-1] == "Thread":
                continue
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            daemon = kw.get("daemon")
            if not (isinstance(daemon, ast.Constant) and daemon.value is True):
                continue
            target = kw.get("target")
            if target is None:
                continue
            name = self._target_name(target)
            if not name:
                continue
            if (
                cls is not None
                and isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                by_class.setdefault(id(cls), set()).add(name)
            else:
                loose.add(name)
        return loose, by_class

    def _loop_is_supervised(self, loop: ast.While) -> bool:
        for node in ast.walk(loop):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if (
                    node.func.attr in self._STOP_METHODS
                    and self._is_stop_receiver(node.func.value)
                ):
                    return True  # stop-Event check gates the loop
                if "heartbeat" in node.func.attr.lower():
                    return True  # e.g. self._stamp_heartbeat()
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    name = (
                        t.attr if isinstance(t, ast.Attribute)
                        else t.id if isinstance(t, ast.Name) else ""
                    )
                    if "heartbeat" in name.lower():
                        return True  # heartbeat stamp
        return False

    def _is_stop_receiver(self, node: ast.expr) -> bool:
        dotted = (_dotted(node) or "").lower()
        return any(tok in dotted for tok in self._STOP_NAME_TOKENS)

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if "gofr_tpu_torch/testutil/" in sf.rel_path:
            return []
        loose, by_class = self._daemon_targets(sf.tree)
        if not loose and not by_class:
            return []
        out: list[Finding] = []
        for node, cls in self._scoped_walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            allowed = loose if cls is None else (
                loose | by_class.get(id(cls), set())
            )
            if node.name not in allowed:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.While):
                    continue
                test = sub.test
                if not (isinstance(test, ast.Constant) and test.value is True):
                    continue
                if self._loop_is_supervised(sub):
                    continue
                out.append(
                    Finding(
                        self.name, sf.rel_path, sub.lineno,
                        f"'while True' in daemon-thread target '{node.name}' "
                        "checks no stop Event and stamps no heartbeat — "
                        "unstoppable AND unwatchable; gate on an Event.wait/"
                        "is_set or stamp a heartbeat each iteration",
                    )
                )
        return out


class PubSubManualSettleRule(Rule):
    """Cross-file: collect subscriber-handler registrations
    (``*.subscribe(topic, handler)`` and
    ``*subscription_manager.register(topic, handler)``) everywhere, flag
    ``commit()``/``nack()`` calls inside those handler functions in
    finalize. The commit check is receiver-filtered (``ctx.request`` /
    ``msg``-ish names) so ``ctx.sql.commit()`` stays clean; ``nack`` is
    pubsub-only vocabulary and flags on any receiver.

    Handlers are matched by bare function/attribute name (an AST lint
    cannot resolve cross-module references) — an unrelated function that
    shares a registered handler's name and settles messages legitimately
    is a known false positive; suppress it with a reason, like every
    other finding in this suite (fix-or-justify)."""

    name = "pubsub-manual-settle"
    cross_file = True

    _MSGISH = {"msg", "message", "request"}

    def __init__(self) -> None:
        self._handlers: set[str] = set()
        # (enclosing function, path, line, method)
        self._sites: list[tuple[str, str, int, str]] = []

    @staticmethod
    def _handler_name(node: ast.expr) -> str | None:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr  # e.g. worker.handler → "handler"
        return None

    def _is_registration(self, call: ast.Call) -> bool:
        func = call.func
        if not isinstance(func, ast.Attribute) or len(call.args) < 2:
            return False
        if func.attr == "subscribe":
            # registration takes (topic, handler); a driver's one-arg
            # subscribe(topic) never gets here because of the arg count
            return True
        if func.attr == "register":
            recv = (_dotted(func.value) or "").rsplit(".", 1)[-1]
            return recv in ("subscription_manager", "manager", "mgr")
        return False

    def _settle_method(self, call: ast.Call) -> str | None:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr == "nack":
            return "nack"
        if func.attr == "commit" and not call.args and not call.keywords:
            recv = _dotted(func.value)
            if recv is None:
                return None
            parts = recv.split(".")
            if parts[-1] in self._MSGISH:
                return "commit"
        return None

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        visitor = _FunctionCalls()
        visitor.visit(sf.tree)
        for call, func_name, _depth in visitor.calls:
            if self._is_registration(call):
                name = self._handler_name(call.args[1])
                if name:
                    self._handlers.add(name)
                continue
            method = self._settle_method(call)
            if (
                method is not None
                and func_name is not None
                and not sf.is_suppressed(self.name, call.lineno)
            ):
                self._sites.append((func_name, sf.rel_path, call.lineno, method))
        return []

    def finalize(self) -> list[Finding]:
        return [
            Finding(
                self.name, path, line,
                f"subscriber handler '{func}' calls .{method}() itself — the "
                "framework loop settles every delivered message (commit on "
                "success, nack/DLQ on failure); drop the manual settle or "
                "suppress with a reason",
            )
            for func, path, line, method in self._sites
            if func in self._handlers
        ]


class RouterRetryTypedRule(Rule):
    """``router-retry-untyped``: except clauses inside the router's
    retry-zone functions (ROUTER_RETRY_ZONES) must name only the typed
    retriable error set. ``except Exception``, a bare ``except``, or any
    unlisted type is a finding — the failover path re-submitting a
    request that failed a 400-class or programming error would duplicate
    work (and a non-idempotent stream) silently."""

    name = "router-retry-untyped"

    def _bad_names(self, handler: ast.ExceptHandler) -> list[str]:
        t = handler.type
        if t is None:
            return ["<bare except>"]
        exprs = list(t.elts) if isinstance(t, ast.Tuple) else [t]
        bad: list[str] = []
        for expr in exprs:
            dotted = _dotted(expr)
            if dotted is None:
                bad.append("<computed>")
                continue
            if dotted.rsplit(".", 1)[-1] not in ROUTER_RETRIABLE_NAMES:
                bad.append(dotted)
        return bad

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        funcs = _zone_functions(ROUTER_RETRY_ZONES, sf.rel_path)
        if funcs is None:
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if funcs != "*" and node.name not in funcs:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.ExceptHandler):
                    continue
                bad = self._bad_names(sub)
                if bad and not sf.is_suppressed(self.name, sub.lineno):
                    out.append(
                        Finding(
                            self.name, sf.rel_path, sub.lineno,
                            f"retry path '{node.name}' catches "
                            f"{', '.join(bad)} — only the typed-retriable "
                            "set (RETRIABLE_ERRORS, or its members / "
                            "ErrorDeadlineExceeded) may be handled here",
                        )
                    )
        return out


def default_rules() -> list[Rule]:
    """These rules and the lockcheck, leakcheck, deadlinecheck and
    kernelcheck families. The reference's shardcheck waits for the port's
    mesh (ROADMAP Queue A item 9)."""
    from gofr_tpu_torch.analysis.deadlinecheck import deadlinecheck_rules
    from gofr_tpu_torch.analysis.kernelcheck import kernelcheck_rules
    from gofr_tpu_torch.analysis.leakcheck import leakcheck_rules
    from gofr_tpu_torch.analysis.lockcheck import lockcheck_rules

    return [
        BlockingCallRule(), HostSyncRule(), CtypesCheckedRule(), MetricsRule(),
        DaemonLoopHeartbeatRule(), PubSubManualSettleRule(),
        RouterRetryTypedRule(),
        *lockcheck_rules(),
        *leakcheck_rules(),
        *deadlinecheck_rules(),
        *kernelcheck_rules(),
    ]
