"""shardcheck: mesh-axis and collective consistency, in-place update and
CUDA-graph capture hazards (port of ``gofr_tpu/analysis/shardcheck.py``).

The reference's four rules, restated over the port's code:

``mesh-axis-unknown``
    Every string-literal axis must be declared by the mesh vocabulary
    (``AXIS_ORDER`` in ``parallel/mesh.py``, or a literal
    ``DeviceMesh(..., mesh_dim_names=(...))`` / ``Mesh(...,
    axis_names=(...))``): in a ``PartitionSpec``/``P(...)`` or a
    ``named_sharding(mesh, ...)``, in the ``axis`` of the port's
    collectives (``psum(x, mesh, "tp")``, ``parallel/collectives.py``), in
    a mesh's own lookups (``mesh.group("tp")``, ``mesh.index``,
    ``mesh.axis_ranks``, ``mesh.shape["tp"]``, ``require_axis(mesh,
    "tp")``), in an ``axis=``/``axis_name=`` keyword or default, and in a
    ``TPU_MESH``-style spec string (``build_mesh("dp=2,tp=4")``,
    ``MeshSpec.parse``, ``mesh_spec=``). Cross-file: only enforced when
    the linted tree declares a mesh.

``collective-unmapped``
    The port has no ``shard_map``: a collective runs on every rank of the
    group its mesh names. A collective with a *literal* axis must sit in
    a function that receives the mesh it runs over (the
    ``*_sharded(..., mesh, axis)`` body convention of
    ``parallel/context_parallel.py`` and ``ops/moe.py``; a method whose
    object holds it counts) or in one handed to ``world.run_spmd`` (the
    rank function, directly, through ``functools.partial`` or an alias,
    or a nested def of one). An axis received as a parameter is the
    caller's contract, as in the reference.

``use-after-donation``
    The reference's donation is the port's in-place update: the
    arguments ``kernel_contracts.py`` lists as ``updated`` are written in
    place and returned again. Reading such an argument after the call is
    reading the call's *result*, so the rule flags the reads where the
    code means the value from *before* the call: the result bound to
    another name and the argument read again before it is rebound; an
    alias (a copy, a tuple, a constructor argument) taken before the call
    and read after it; the call in a loop that never rebinds the argument
    (the next pass starts from this pass's update). A bare call statement
    (the result dropped) is torch's in-place idiom and is not scanned;
    metadata reads (``.shape``/``.dtype``/``.device``/...) are exempt.

``retrace-hazard``
    In the decode hot path (``serving/engine.py``, ``batch.py``,
    ``stepplan.py``, ``kv_cache.py``, ``lora.py``, ``ops/``) a kernel entry
    of the contract table must stay capturable into one CUDA graph per
    shape bucket: flags Python ``if``/``while`` on a tensor (non-static)
    parameter's value, ``int()``/``float()``/``bool()``/``.item()`` of
    one (a host sync per call), unhashable values in a static position
    (a mutable default at the def, a list/dict/set literal at a call
    site), and ``torch.compile``/``torch.cuda.graph``/``CUDAGraph()``
    built inside a hot-path function body (a fresh wrapper per call).
    ``x is None``, ``isinstance``/``len`` and ``.shape``/``.ndim``/
    ``.dtype`` stay exempt.

All rules honour the fix-or-justify suppressions
(``# gofrlint: disable=<rule> -- <reason>``).
"""

from __future__ import annotations

import ast
import dataclasses
import re

from gofr_tpu_torch.analysis import kernel_contracts as kc
from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# ---------------------------------------------------------------------------
# shared AST helpers

#: the port's collectives (parallel/collectives.py) -> positional index of
#: their axis argument; the mesh sits just before it
COLLECTIVES: dict[str, int] = {
    "psum": 2,
    "pmean": 2,
    "copy_to": 2,
    "all_gather": 2,
    "gather_from": 2,
    "split_to": 2,
    "all_to_all": 2,
    "ppermute": 2,
    "axis_index": 1,
}
_COLLECTIVE_MODULES = ("collectives", "parallel.collectives",
                       "gofr_tpu_torch.parallel.collectives")

RUN_SPMD_NAMES = {"run_spmd"}
PARTITION_SPEC_NAMES = {"P", "PartitionSpec"}
#: a mesh's own axis lookups: mesh.group("tp"), mesh.index("tp"), ...
MESH_LOOKUPS = {"group", "index", "axis_ranks"}
#: calls whose first string argument is a TPU_MESH-style spec ("dp=2,tp=4")
MESH_SPEC_CALLS = {"build_mesh", "parse"}

#: attribute reads that an in-place update leaves as they were
BENIGN_ATTRS = {"shape", "ndim", "dtype", "size", "device", "sharding", "aval"}
#: tensor methods that read metadata only: static under a capture
STATIC_METHODS = {"numel", "dim", "size", "stride", "element_size", "is_contiguous",
                  "get_device"}

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)

#: the decode hot path of the retrace rule: the reference's zones, in the
#: port's files (a CUDA graph captures each dispatch once per bucket)
RETRACE_ZONE_FILES = (
    "gofr_tpu_torch/serving/engine.py",
    "gofr_tpu_torch/serving/batch.py",
    "gofr_tpu_torch/serving/stepplan.py",
    "gofr_tpu_torch/serving/kv_cache.py",
    "gofr_tpu_torch/serving/lora.py",
)
RETRACE_ZONE_DIRS = ("gofr_tpu_torch/ops/",)

#: calls that build a compiled or captured callable
_CAPTURE_BUILDERS = {"torch.compile", "compile", "torch.cuda.graph", "cuda.graph",
                     "torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
                     "torch.cuda.make_graphed_callables", "make_graphed_callables"}


def _dotted(node: ast.expr) -> str | None:
    """'torch.cuda.graph' for Name/Attribute chains; None otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _chain_attrs(node: ast.expr) -> set[str]:
    """Every attribute name along a Name/Attribute chain."""
    out = set()
    while isinstance(node, ast.Attribute):
        out.add(node.attr)
        node = node.value
    return out


def _root(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_collective(call: ast.Call) -> str | None:
    """Collective name when the call is <c> / collectives.<c>."""
    dotted = _dotted(call.func)
    if dotted is None:
        return None
    name = dotted.rsplit(".", 1)[-1]
    if name not in COLLECTIVES:
        return None
    if dotted == name or any(dotted == f"{m}.{name}" for m in _COLLECTIVE_MODULES):
        return name
    return None


def _collective_arg(call: ast.Call, name: str, what: str) -> ast.expr | None:
    """The axis (``what="axis"``) or mesh argument of a collective call."""
    pos = COLLECTIVES[name] - (1 if what == "mesh" else 0)
    for kw in call.keywords:
        if kw.arg == what:
            return kw.value
    if len(call.args) > pos and not any(isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
        return call.args[pos]
    return None


def _literal_axes(node: ast.expr) -> list[tuple[str, int]]:
    """String-literal axis names in an axis expression: 'tp',
    ('dp', 'fsdp'), {'ep'} — with line numbers."""
    out: list[tuple[str, int]] = []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.append((node.value, node.lineno))
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for elt in node.elts:
            out.extend(_literal_axes(elt))
    return out


def _spec_string_axes(node: ast.expr) -> list[tuple[str, int]]:
    """Axis names of a literal TPU_MESH spec string ("dp=2,tp=4")."""
    if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
        return []
    out = []
    for part in node.value.split(","):
        axis, sep, _ = part.partition("=")
        if sep and axis.strip():
            out.append((axis.strip(), node.lineno))
    return out


def _func_params(node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda) -> list[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
    names += [p.arg for p in a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _imports_name(sf: SourceFile, name: str) -> bool:
    """Whether the file binds ``name`` by a ``from ... import``."""
    if not re.search(rf"\bimport\b[^\n]*\b{re.escape(name)}\b", sf.source) \
            and f"import (" not in sf.source:
        return False
    return any(
        isinstance(n, ast.ImportFrom) and any((al.asname or al.name) == name for al in n.names)
        for n in ast.walk(sf.tree)
    )


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A contract-table entry as the rules see it: where it is defined,
    its positional parameters, the ones updated in place and the static
    (Python value) ones."""

    name: str
    path: str
    params: tuple[str, ...]
    updated: tuple[str, ...]
    static: tuple[str, ...]

    def positions(self, names: tuple[str, ...]) -> tuple[int, ...]:
        return tuple(sorted(self.params.index(n) for n in names if n in self.params))


def kernel_specs(contracts=None) -> dict[str, KernelSpec]:
    """The contract table (``kernel_contracts.KERNELS`` by default) by name."""
    return {
        k.name: KernelSpec(k.name, k.file, tuple(k.params), tuple(k.updated), tuple(k.static))
        for k in (kc.KERNELS if contracts is None else contracts)
    }


# ---------------------------------------------------------------------------
# rule 1: mesh-axis vocabulary (cross-file)


class MeshAxisRule(Rule):
    """Collects the declared vocabulary (AXIS_ORDER, literal DeviceMesh /
    Mesh axis names) across the tree, then checks every literal axis
    usage against it in finalize. Inert when the linted subset declares
    no mesh: a partial lint must not flood."""

    name = "mesh-axis-unknown"
    cross_file = True

    def __init__(self) -> None:
        self._declared: set[str] = set()
        self._usages: list[tuple[str, str, int, str]] = []  # axis, path, line, ctx

    def _use(self, sf: SourceFile, axes: list[tuple[str, int]], ctx: str) -> None:
        self._usages.extend((axis, sf.rel_path, line, ctx) for axis, line in axes)

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        has_pspec = "PartitionSpec" in sf.source or _imports_name(sf, "P")
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "AXIS_ORDER":
                        self._declared.update(a for a, _ in _literal_axes(node.value))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_axis_defaults(sf, node)
            if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute) \
                    and node.value.attr == "shape" and _names_mesh(node.value.value):
                self._use(sf, _literal_axes(node.slice), "mesh.shape key")
            if not isinstance(node, ast.Call):
                continue
            term = _terminal(node.func)
            kws = {kw.arg: kw.value for kw in node.keywords if kw.arg}
            if term in ("Mesh", "DeviceMesh"):
                for key in ("axis_names", "mesh_dim_names"):
                    if key in kws:
                        self._declared.update(a for a, _ in _literal_axes(kws[key]))
                continue
            if term in PARTITION_SPEC_NAMES and has_pspec:
                for arg in node.args:
                    self._use(sf, _literal_axes(arg), "PartitionSpec axis")
            elif term == "named_sharding":
                for arg in node.args[1:]:
                    self._use(sf, _literal_axes(arg), "named_sharding axis")
            elif term == "require_axis" and len(node.args) >= 2:
                self._use(sf, _literal_axes(node.args[1]), "require_axis axis")
            elif term in MESH_LOOKUPS and isinstance(node.func, ast.Attribute) \
                    and _names_mesh(node.func.value) and node.args:
                self._use(sf, _literal_axes(node.args[0]), f"mesh.{term} axis")
            elif term in MESH_SPEC_CALLS and node.args and (
                    term == "build_mesh" or _dotted(node.func) in ("MeshSpec.parse",
                                                                   "mesh.MeshSpec.parse")):
                self._use(sf, _spec_string_axes(node.args[0]), "mesh spec string")
            coll = _is_collective(node)
            if coll is not None:
                axis_arg = _collective_arg(node, coll, "axis")
                if axis_arg is not None:
                    self._use(sf, _literal_axes(axis_arg), f"{coll} axis")
                continue
            if "mesh_spec" in kws:
                self._use(sf, _spec_string_axes(kws["mesh_spec"]), "mesh spec string")
            for key in ("axis", "axis_name"):
                value = kws.get(key)
                if isinstance(value, ast.Constant) and isinstance(value.value, str):
                    self._use(sf, [(value.value, value.lineno)], f"{key}= keyword")
        return []

    def _scan_axis_defaults(self, sf: SourceFile, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        a = fn.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
        for param, default in pairs:
            if param.arg in ("axis", "axis_name") and isinstance(default, ast.Constant) \
                    and isinstance(default.value, str):
                self._use(sf, [(default.value, default.lineno)],
                          f"default of parameter '{param.arg}'")

    def finalize(self) -> list[Finding]:
        if not self._declared:
            return []
        return [
            Finding(
                self.name, path, line,
                f"axis '{axis}' ({ctx}) is not declared by the mesh "
                f"(known axes: {', '.join(sorted(self._declared))}) — a typo here "
                "raises in require_axis at run time, on the one topology that "
                "exercises it, or picks the wrong group",
            )
            for axis, path, line, ctx in self._usages
            if axis not in self._declared
        ]


def _names_mesh(node: ast.expr) -> bool:
    """Whether an expression names a mesh by its last name component
    (``mesh``, ``self.mesh``, ``tp4_mesh``, ``cp_mesh``)."""
    term = _terminal(node)
    return bool(term) and "mesh" in term.lower()


# ---------------------------------------------------------------------------
# rule 2: collectives outside any rank function or received mesh (per-file)


class _RankFunctionCollector(ast.NodeVisitor):
    """Names (and lambdas) of functions this file hands to run_spmd:
    directly, through functools.partial, or a one-step alias."""

    def __init__(self) -> None:
        self.mapped: set[str] = set()
        self.mapped_lambdas: set[int] = set()
        self._partial_alias: dict[str, str] = {}

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            dotted = _dotted(node.value.func)
            if dotted in ("partial", "functools.partial") and node.value.args:
                target = _terminal(node.value.args[0])
                if target:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self._partial_alias[tgt.id] = target
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if _terminal(node.func) in RUN_SPMD_NAMES and node.args:
            fn = node.args[0]
            if isinstance(fn, ast.Lambda):
                self.mapped_lambdas.add(id(fn))
            elif isinstance(fn, ast.Call) and _dotted(fn.func) in ("partial", "functools.partial") \
                    and fn.args:
                inner = _terminal(fn.args[0])
                if inner:
                    self.mapped.add(inner)
            else:
                name = _terminal(fn)
                if name:
                    self.mapped.add(name)
                    self.mapped.add(self._partial_alias.get(name, name))
        self.generic_visit(node)


class _CollectiveVisitor(ast.NodeVisitor):
    """Collective calls with their enclosing function/lambda stack."""

    def __init__(self) -> None:
        self.found: list[tuple[ast.Call, str, list[tuple[str, list[str], int]]]] = []
        self._stack: list[tuple[str, list[str], int]] = []

    def _visit_func(self, node):
        self._stack.append((node.name, _func_params(node), id(node)))
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._stack.append(("<lambda>", _func_params(node), id(node)))
        self.generic_visit(node)
        self._stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        coll = _is_collective(node)
        if coll is not None:
            self.found.append((node, coll, list(self._stack)))
        self.generic_visit(node)


class CollectiveMappedRule(Rule):
    name = "collective-unmapped"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if not any(c in sf.source for c in COLLECTIVES):
            return []
        ranks = _RankFunctionCollector()
        ranks.visit(sf.tree)
        visitor = _CollectiveVisitor()
        visitor.visit(sf.tree)
        out: list[Finding] = []
        for call, coll, stack in visitor.found:
            axis_arg = _collective_arg(call, coll, "axis")
            if axis_arg is None:
                continue
            params = {p for _, ps, _ in stack for p in ps}
            # an axis received as a parameter is the caller's contract
            if isinstance(axis_arg, ast.Name) and axis_arg.id in params:
                continue
            literals = _literal_axes(axis_arg)
            if not literals:
                continue  # a computed axis: not statically resolvable
            mesh_arg = _collective_arg(call, coll, "mesh")
            if mesh_arg is not None and _root(mesh_arg) in params:
                continue  # the function receives the mesh it runs over
            if any(name in ranks.mapped or nid in ranks.mapped_lambdas for name, _, nid in stack):
                continue  # a rank function of run_spmd
            axes = ", ".join(a for a, _ in literals)
            where = f"function '{stack[-1][0]}'" if stack else "module scope"
            out.append(
                Finding(
                    self.name, sf.rel_path, call.lineno,
                    f"{coll}('{axes}') in {where} runs over a mesh the code "
                    "neither receives nor runs under run_spmd — outside a rank "
                    "function the collective runs on whatever world (or none) "
                    "is up, on a group its caller never chose; take the mesh as "
                    "a parameter, or run the function through run_spmd",
                )
            )
        return out


# ---------------------------------------------------------------------------
# rule 3: reads of an in-place-updated argument as its pre-call value


def _assigned_dotted(stmt: ast.stmt) -> set[str]:
    """Dotted names (re)bound by an assignment statement's targets."""
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: set[str] = set()
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        elif (d := _dotted(t)) is not None:
            out.add(d)
    return out


def _name_events(node: ast.AST, tracked: str) -> list[tuple[str, int]]:
    """('load'|'store', line) events for ``tracked`` (a dotted name) in
    execution order. A store to a strict dotted prefix (rebinding the
    root object) counts as a store; loads whose only consumer is a benign
    metadata attribute are skipped."""
    events: list[tuple[str, int]] = []

    def prefix_store(expr: ast.expr) -> bool:
        d = _dotted(expr)
        return d is not None and tracked.startswith(d + ".")

    def walk(n: ast.AST, benign_parent: bool) -> None:
        if isinstance(n, _SCOPE_NODES):
            return  # a nested def/class runs at another time
        if isinstance(n, (ast.Name, ast.Attribute)):
            ctx = getattr(n, "ctx", None)
            if _dotted(n) == tracked or (isinstance(ctx, (ast.Store, ast.Del)) and prefix_store(n)):
                if isinstance(ctx, (ast.Store, ast.Del)):
                    events.append(("store", n.lineno))
                elif not benign_parent:
                    events.append(("load", n.lineno))
                return
        benign = isinstance(n, ast.Attribute) and n.attr in BENIGN_ATTRS
        # an assignment's value runs before its targets
        if isinstance(n, ast.Assign):
            walk(n.value, benign)
            for t in n.targets:
                walk(t, benign)
            return
        if isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            if getattr(n, "value", None) is not None:
                walk(n.value, benign)
            if isinstance(n, ast.AugAssign) and _dotted(n.target) == tracked:
                events.append(("load", n.target.lineno))  # x += 1 reads x
            walk(n.target, benign)
            return
        for child in ast.iter_child_nodes(n):
            walk(child, benign)

    walk(node, False)
    return events


def _local_function_names(tree: ast.AST) -> set[str]:
    return {n.name for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _header_exprs(stmt: ast.stmt) -> list[ast.expr]:
    """Expressions a compound statement evaluates before its blocks run."""
    out: list[ast.expr] = []
    if isinstance(stmt, (ast.If, ast.While)):
        out.append(stmt.test)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        out.append(stmt.iter)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        out.extend(item.context_expr for item in stmt.items)
    subject = getattr(stmt, "subject", None)
    if subject is not None:
        out.append(subject)
    return out


class DonationRule(Rule):
    """Reads of an argument a contract kernel updates in place, where the
    code means its value from before the call. The kernels come from the
    contract table (``contracts=`` replaces it, for fixtures); a call
    matches by its bare terminal name, and a file that defines its own
    function of that name (other than the contract's own file) shadows
    the table there."""

    name = "use-after-donation"

    def __init__(self, contracts=None) -> None:
        self._registry = {k: s for k, s in kernel_specs(contracts).items() if s.updated}

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if not any(name in sf.source for name in self._registry):
            return []
        self._shadowed = {
            n for n in _local_function_names(sf.tree)
            if n in self._registry and not sf.rel_path.endswith(self._registry[n].path)
        }
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            is_loop = isinstance(node, (ast.For, ast.AsyncFor, ast.While))
            loop_targets: set[str] = set()
            if isinstance(node, (ast.For, ast.AsyncFor)):
                loop_targets = _assigned_dotted(ast.Assign(targets=[node.target], value=node.iter))
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if isinstance(block, list) and block and isinstance(block[0], ast.stmt):
                    self._check_block(sf.rel_path, block, out, in_loop=is_loop and field == "body",
                                      loop_targets=loop_targets)
        return [f for f in out if not sf.is_suppressed(f.rule, f.line)]

    def _updated_vars(self, call: ast.Call, spec: KernelSpec) -> list[str]:
        out: list[str] = []
        for pos in spec.positions(spec.updated):
            if pos < len(call.args) and not any(isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
                if (d := _dotted(call.args[pos])) is not None:
                    out.append(d)
        for kw in call.keywords:
            if kw.arg in spec.updated and (d := _dotted(kw.value)) is not None:
                out.append(d)
        return out

    def _updating_calls(self, stmt: ast.AST) -> list[tuple[ast.Call, KernelSpec]]:
        """Updating calls this statement runs (nested def/class bodies run
        at another time and are checked at their own block)."""
        calls: list[tuple[ast.Call, KernelSpec]] = []

        def walk(node: ast.AST) -> None:
            if isinstance(node, _SCOPE_NODES):
                return
            if isinstance(node, ast.Call):
                term = _terminal(node.func)
                if term in self._registry and term not in self._shadowed:
                    calls.append((node, self._registry[term]))
            for child in ast.iter_child_nodes(node):
                walk(child)

        walk(stmt)
        return calls

    def _check_block(self, rel_path: str, block: list[ast.stmt], out: list[Finding], *,
                     in_loop: bool, loop_targets: set[str]) -> None:
        for i, stmt in enumerate(block):
            if hasattr(stmt, "body"):
                # a compound statement: calls in its blocks are checked with
                # those blocks (where inner rebinds are visible); calls in
                # its header belong to no block and are checked here
                for expr in _header_exprs(stmt):
                    for call, spec in self._updating_calls(expr):
                        for var in self._updated_vars(call, spec):
                            if any(kind == "store" for kind, _ in _name_events(stmt, var)):
                                continue
                            self._scan_after(rel_path, block[i + 1:], var, spec, call.lineno, out)
                continue
            bare = isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            for call, spec in self._updating_calls(stmt):
                rebound = _assigned_dotted(stmt)
                for var in self._updated_vars(call, spec):
                    # an alias taken before the call shares the updated storage
                    for alias, cap_line in self._alias_captures(block[:i], var):
                        self._scan_after_alias(rel_path, block[i + 1:], alias, var, cap_line,
                                               spec, call.lineno, out)
                    if bare and stmt.value is call:
                        continue  # f(x) alone: torch's in-place idiom, x is the result
                    if var in rebound or any(var.startswith(r + ".") for r in rebound):
                        continue  # x = f(x): the idiom
                    self._scan_after(rel_path, block[i + 1:], var, spec, call.lineno, out)
                    in_loop_target = var in loop_targets or any(
                        var.startswith(t + ".") for t in loop_targets)
                    if in_loop and not in_loop_target and not self._stored_in_block(block, var):
                        out.append(
                            Finding(
                                self.name, rel_path, call.lineno,
                                f"'{var}' is updated in place by {spec.name}() inside a "
                                "loop and never rebound in the loop body — the next pass "
                                "starts from this pass's update, not from the value the "
                                "loop began with; rebind the result or hoist the call",
                            )
                        )

    @staticmethod
    def _alias_captures(preceding: list[ast.stmt], var: str) -> list[tuple[str, int]]:
        """(alias, line): names assigned before the call whose value holds
        ``var``'s storage — a copy, a tuple/list holding it, or a
        call/constructor argument. A capture rebound before the call drops
        out."""

        def captures(expr: ast.expr) -> bool:
            if isinstance(expr, (ast.Name, ast.Attribute)):
                return _dotted(expr) == var
            if isinstance(expr, ast.Call):
                return any(captures(a) for a in expr.args if not isinstance(a, ast.Starred)) \
                    or any(kw.value is not None and captures(kw.value) for kw in expr.keywords)
            if isinstance(expr, (ast.Tuple, ast.List)):
                return any(captures(e) for e in expr.elts)
            return False

        found: dict[str, int] = {}
        for stmt in preceding:
            if not isinstance(stmt, ast.Assign):
                continue
            is_capture = captures(stmt.value)
            for t in stmt.targets:
                d = _dotted(t)
                if not d or d == var:
                    continue
                if is_capture:
                    found[d] = stmt.lineno
                else:
                    found.pop(d, None)
        return list(found.items())

    def _scan_after_alias(self, rel_path: str, rest: list[ast.stmt], alias: str, var: str,
                          cap_line: int, spec: KernelSpec, call_line: int,
                          out: list[Finding]) -> None:
        """Flag the first load of ``alias`` (or an ``alias.<attr>`` chain)
        after the call, before the alias is rebound; a store onto the
        alias (``rec.steps = 2``) is no read."""
        events: list[tuple[str, int]] = []

        def walk(n: ast.AST) -> None:
            if isinstance(n, _SCOPE_NODES):
                return
            if isinstance(n, (ast.Name, ast.Attribute)):
                d = _dotted(n)
                if d and (d == alias or d.startswith(alias + ".") or alias.startswith(d + ".")):
                    if isinstance(getattr(n, "ctx", None), (ast.Store, ast.Del)):
                        events.append(("store", n.lineno))
                    elif d == alias or d.startswith(alias + "."):
                        events.append(("load", n.lineno))
                    return
            if isinstance(n, ast.Assign):
                walk(n.value)
                for t in n.targets:
                    walk(t)
                return
            if isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                if getattr(n, "value", None) is not None:
                    walk(n.value)
                if isinstance(n, ast.AugAssign):
                    d = _dotted(n.target)
                    if d and (d == alias or d.startswith(alias + ".")):
                        events.append(("load", n.target.lineno))
                walk(n.target)
                return
            for child in ast.iter_child_nodes(n):
                walk(child)

        for stmt in rest:
            events.clear()
            walk(stmt)
            for kind, line in events:
                if kind == "store":
                    return
                out.append(
                    Finding(
                        self.name, rel_path, line,
                        f"'{alias}' (captured from '{var}' on line {cap_line}) shares the "
                        f"storage {spec.name}() updates in place on line {call_line} and is "
                        "read after the call — it holds the updated contents, not the value "
                        "it captured; clone before the call or re-derive it from the outputs",
                    )
                )
                return

    @staticmethod
    def _stored_in_block(block: list[ast.stmt], var: str) -> bool:
        return any(kind == "store" for stmt in block for kind, _ in _name_events(stmt, var))

    def _scan_after(self, rel_path: str, rest: list[ast.stmt], var: str, spec: KernelSpec,
                    call_line: int, out: list[Finding]) -> None:
        for stmt in rest:
            for kind, line in _name_events(stmt, var):
                if kind == "store":
                    return
                out.append(
                    Finding(
                        self.name, rel_path, line,
                        f"'{var}' was updated in place by {spec.name}() on line {call_line} "
                        "while its result went elsewhere, and is read again before "
                        "rebinding — it holds the call's result, not the value from before "
                        "the call; rebind the result, or clone before the call",
                    )
                )
                return


# ---------------------------------------------------------------------------
# rule 4: capture (retrace) hazards in the decode hot path


def _in_retrace_zone(rel_path: str) -> bool:
    if any(rel_path.endswith(f) for f in RETRACE_ZONE_FILES):
        return True
    return any(d in rel_path for d in RETRACE_ZONE_DIRS)


def _hazard_roots(test: ast.expr) -> list[tuple[str, int]]:
    """Root names whose runtime value the test depends on, skipping what
    is static under a capture: ``is (not) None``, isinstance/len/hasattr
    calls, and ``.shape``/``.ndim``/``.dtype``/... inspection."""
    roots: list[tuple[str, int]] = []
    static_calls = {"isinstance", "len", "hasattr", "getattr", "type"}

    def walk(n: ast.AST) -> None:
        if isinstance(n, ast.Compare) and all(isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            return
        if isinstance(n, ast.Call) and (_terminal(n.func) in static_calls or (
                isinstance(n.func, ast.Attribute) and n.func.attr in STATIC_METHODS)):
            return
        if isinstance(n, ast.Attribute):
            if _chain_attrs(n) & BENIGN_ATTRS:
                return
            if (root := _root(n)) is not None:
                roots.append((root, n.lineno))
            return
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            roots.append((n.id, n.lineno))
            return
        for child in ast.iter_child_nodes(n):
            walk(child)

    walk(test)
    return roots


class _KernelBodyChecker(ast.NodeVisitor):
    """Hazards inside one contract kernel's body."""

    def __init__(self, spec: KernelSpec, fn: ast.FunctionDef | ast.AsyncFunctionDef,
                 rel_path: str) -> None:
        self.spec = spec
        self.rel_path = rel_path
        self.traced = {p for p in spec.params if p not in spec.static}
        self.findings: list[Finding] = []
        self._fn = fn

    def run(self) -> list[Finding]:
        for stmt in self._fn.body:
            self.visit(stmt)
        return self.findings

    def _check_test(self, node: ast.If | ast.While | ast.IfExp) -> None:
        for name, line in _hazard_roots(node.test):
            if name in self.traced:
                self.findings.append(
                    Finding(
                        "retrace-hazard", self.rel_path, line,
                        f"Python branch on tensor parameter '{name}' inside kernel "
                        f"entry {self.spec.name}() — a host sync on every call, and a "
                        "CUDA graph captures only the branch taken at capture; use "
                        "torch.where, or make the parameter a static of the contract",
                    )
                )
                break

    def visit_If(self, node: ast.If) -> None:
        self._check_test(node)
        self.generic_visit(node)

    visit_While = visit_If
    visit_IfExp = visit_If

    def visit_Call(self, node: ast.Call) -> None:
        func = _dotted(node.func)
        target = None
        if func in ("int", "float", "bool") and node.args:
            target = node.args[0]
        elif isinstance(node.func, ast.Attribute) and node.func.attr in ("item", "tolist") \
                and not node.args:
            target = node.func.value
            func = f".{node.func.attr}"
        root = _root(target) if target is not None else None
        if root in self.traced:
            self.findings.append(
                Finding(
                    "retrace-hazard", self.rel_path, node.lineno,
                    f"{func}() reads tensor parameter '{root}' to the host inside kernel "
                    f"entry {self.spec.name}() — a host sync per call, and a CUDA graph "
                    "bakes in the value seen at capture",
                )
            )
        self.generic_visit(node)


_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)


class RetraceRule(Rule):
    """Capture hazards in the decode hot path: the contract kernels'
    bodies, their static positions at the def and at every call site in
    the zone, and compiled or captured callables built per call."""

    name = "retrace-hazard"

    def __init__(self, contracts=None) -> None:
        self._registry = kernel_specs(contracts)

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if not _in_retrace_zone(sf.rel_path):
            return []
        local = _local_function_names(sf.tree)
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                spec = self._registry.get(node.name)
                if spec is not None and sf.rel_path.endswith(spec.path):
                    out.extend(_KernelBodyChecker(spec, node, sf.rel_path).run())
                    out.extend(self._check_static_defaults(sf, node, spec))
            elif isinstance(node, ast.Call):
                term = _terminal(node.func)
                spec = self._registry.get(term or "")
                if spec is None or (term in local and not sf.rel_path.endswith(spec.path)):
                    continue
                out.extend(self._check_static_call(sf, node, spec))
        out.extend(self._check_capture_in_body(sf))
        return out

    def _check_static_defaults(self, sf: SourceFile, fn: ast.FunctionDef | ast.AsyncFunctionDef,
                               spec: KernelSpec) -> list[Finding]:
        a = fn.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
        return [
            Finding(
                self.name, sf.rel_path, default.lineno,
                f"static parameter '{param.arg}' of kernel entry {fn.name}() has an "
                "unhashable default — a static is a capture's key, and must be "
                "hashable (use a tuple/frozenset)",
            )
            for param, default in pairs
            if param.arg in spec.static and isinstance(default, _UNHASHABLE)
        ]

    def _check_static_call(self, sf: SourceFile, call: ast.Call, spec: KernelSpec) -> list[Finding]:
        out = []
        for pos in spec.positions(spec.static):
            if pos < len(call.args) and isinstance(call.args[pos], _UNHASHABLE):
                out.append(Finding(
                    self.name, sf.rel_path, call.args[pos].lineno,
                    f"unhashable literal in static position {pos} of {spec.name}() — a "
                    "static is a capture's key (pass a tuple, or make it a tensor "
                    "argument)",
                ))
        for kw in call.keywords:
            if kw.arg in spec.static and isinstance(kw.value, _UNHASHABLE):
                out.append(Finding(
                    self.name, sf.rel_path, kw.value.lineno,
                    f"unhashable literal for static argument '{kw.arg}' of {spec.name}() "
                    "— a static is a capture's key",
                ))
        return out

    def _check_capture_in_body(self, sf: SourceFile) -> list[Finding]:
        """A compiled or captured callable built under a function body: a
        fresh one per call, whose compile or capture is paid every time
        (decorators run once, at import, and stay exempt)."""
        out: list[Finding] = []

        class V(ast.NodeVisitor):
            depth = 0

            def _visit_func(self, node):
                for deco in node.decorator_list:
                    self.visit(deco)
                self.depth += 1
                for stmt in node.body:
                    self.visit(stmt)
                self.depth -= 1

            visit_FunctionDef = _visit_func
            visit_AsyncFunctionDef = _visit_func

            def visit_Call(self, node: ast.Call) -> None:
                dotted = _dotted(node.func)
                if self.depth > 0 and dotted in _CAPTURE_BUILDERS and (
                        dotted != "compile" or _imports_name(sf, "compile")):
                    out.append(
                        Finding(
                            "retrace-hazard", sf.rel_path, node.lineno,
                            f"{dotted}() called inside a hot-path function — each call "
                            "builds a fresh compiled or captured callable (a compile or "
                            "capture per request); build it once, outside the call",
                        )
                    )
                self.generic_visit(node)

        V().visit(sf.tree)
        return out


def shardcheck_rules() -> list[Rule]:
    return [MeshAxisRule(), CollectiveMappedRule(), DonationRule(), RetraceRule()]
