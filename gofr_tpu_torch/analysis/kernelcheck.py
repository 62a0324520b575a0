"""kernelcheck — device-contract analysis of the port's kernel layer.

The port's copy of ``gofr_tpu/analysis/kernelcheck.py``. The serving data
plane runs on contracts the code does not state: ``decode_block*``
returns ONE packed ``int32 [B, steps+2]`` array whose columns the host
slices by offset, and the ``DecodeState`` carry is constructed at
several sites that must agree field for field.
:mod:`gofr_tpu_torch.analysis.kernel_contracts` makes those contracts a
committed table; this module makes drift from the table a lint failure.
Rule families:

- ``pack-layout-drift`` — kernel side: every contract entry with a
  declared packed layout must build it through the declared pack helper
  (and the helper's ``torch.cat`` order must match the declared
  columns); host side: unpack sites (``engine._consume``,
  ``engine._spec_step``) may slice a ``_block_sync``-tainted packed
  array only at offsets the layout declares, binding names must match
  the column they read, and every declared scalar column must be
  consumed — so a kernel-side pack edit without a matching unpack edit
  fails loud.
- ``dtype-discipline`` — hot-zone dtype hygiene, restated for torch. The
  reference forbids every 64-bit dtype; the port's gather and index
  tensors and its token fields are int64 by torch's contract, so what
  the port forbids is: float64 in the hot zone (``torch.float64``,
  ``torch.double``, ``np.float64``, ``.double()``); ``torch.tensor(...)``
  of a Python literal with no ``dtype``/``device`` in the hot zone (a
  default-dtype host tensor, then a copy); and int64 where the table
  declares int32 — in a pack helper, whose output is the int32 packed
  layout.
- ``carry-field-drift`` — every DecodeState construction site (the
  dataclass, ``make_decode_state`` incl. per-field dtypes,
  ``admit_decode_state`` incl. full-field coverage, every
  ``DecodeState(...)`` call, the engine's ``_pending_admit`` tuple arity)
  must agree with the declared carry spec.
- ``kernel-contract-coverage`` — every public module-level function in
  the declared kernel files must carry a contract whose params and
  static set match the signature (statics read from the annotations:
  the config, ints, floats, bools), or stand in
  ``kernel_contracts.HOST_HELPERS`` with its reason; stale contract
  entries, stale helper entries and vanished unpack-site functions fail.

- ``spec-rank-mismatch`` — the reference's ``shard_map`` plumbing checks
  over the port's mesh: a ``compile(name, fn, *examples,
  in_shardings=, out_shardings=)`` call's spec counts against ``fn``'s
  arity, its examples and its returned tuple, and each ``P(...)``'s arity
  against the parameter's declared rank (trailing ``# [B, S, H, D]``
  comments); a higher-order wrapper's call of its body
  (``context_parallel._global_view``) against the bodies handed to it;
  ``local_index``/``shard_leaf``/``with_constraint`` specs against the
  declared rank they place; and each ``<model>_sharding_rules`` entry
  against the leaves of ``models/<model>.py``'s ``init_params``.

The runtime twin (:mod:`gofr_tpu_torch.analysis.kerneltrace`) runs every
contract entry on the CPU or observes a live engine, and
``--check-kernel-table`` verifies the export against the same table
(:func:`check_kernel_table`).
"""

from __future__ import annotations

import ast
import re
from typing import Any

from gofr_tpu_torch.analysis import kernel_contracts as kc
from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# --------------------------------------------------------------- helpers


def _terminal(node: ast.AST) -> str | None:
    """Last component of a Name/Attribute chain (``torch.cat`` -> ``cat``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> str | None:
    """Full dotted name (``torch.tensor``) or None for non-chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _int_const(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _positional_params(fn: ast.FunctionDef) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _all_params(fn: ast.FunctionDef) -> list[str]:
    return _positional_params(fn) + [a.arg for a in fn.args.kwonlyargs]


# annotation names of a Python-value (static) parameter
_STATIC_ANNOTATIONS = {"int", "float", "bool", "LlamaConfig", "None"}


def _annotation_names(node: ast.AST) -> set[str]:
    """Terminal type names of an annotation (``llama.LlamaConfig`` ->
    ``LlamaConfig``; ``float | None`` -> ``float``, ``None``)."""
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    if isinstance(node, ast.Constant):
        return {"None"} if node.value is None else {str(node.value)}
    out: set[str] = set()
    for child in ast.iter_child_nodes(node):
        out |= _annotation_names(child)
    return out


def _static_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters whose annotation names only Python scalar types or the
    config (``int``, ``float | None``, ``llama.LlamaConfig``): the port's
    counterpart of the reference's ``static_argnums``."""
    out: set[str] = set()
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if a.annotation is None:
            continue
        names = _annotation_names(a.annotation)
        if names and names <= _STATIC_ANNOTATIONS:
            out.add(a.arg)
    return out


def _find_def(tree: ast.AST, name: str) -> ast.FunctionDef | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _mentions(node: ast.AST, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == name:
            return True
    return False


# ------------------------------------------------------ pack-layout-drift

_PACK_HELPERS = kc.PACK_HELPERS
_CASTS = {"int", "bool", "float", "asarray", "array", "tensor"}


def _called_closure(
    fn: ast.FunctionDef, module_defs: dict[str, ast.FunctionDef]
) -> set[str]:
    """Terminal names of every call in ``fn`` and, transitively, in the
    same module's private (``_``-prefixed) functions it calls — the
    ragged entries share one body (``_ragged_step``) that packs."""
    called: set[str] = set()
    todo = [fn]
    seen: set[str] = set()
    while todo:
        cur = todo.pop()
        for n in ast.walk(cur):
            if not isinstance(n, ast.Call):
                continue
            name = _terminal(n.func)
            if name is None:
                continue
            called.add(name)
            if name.startswith("_") and name not in _PACK_HELPERS \
                    and name in module_defs and name not in seen:
                seen.add(name)
                todo.append(module_defs[name])
    return called


class PackLayoutRule(Rule):
    """Kernel-side pack construction and host-side packed-column slicing
    must both match the declared :data:`kernel_contracts.PACK_LAYOUTS`."""

    name = "pack-layout-drift"

    # ---- kernel side
    def _check_kernel_file(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        contracts = kc.contracts_for_file(sf.rel_path)
        module_defs = {
            n.name: n for n in sf.tree.body if isinstance(n, ast.FunctionDef)
        }
        for node in sf.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name in _PACK_HELPERS:
                out.extend(self._check_helper(sf, node))
            c = contracts.get(node.name)
            if c is None or c.packed is None:
                continue
            called = _called_closure(node, module_defs)
            if c.pack_helper:
                if c.pack_helper not in called:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"kernel '{node.name}' declares packed layout "
                        f"'{c.packed}' but never calls its pack helper "
                        f"{c.pack_helper}() — the host unpack offsets "
                        "are pinned to that helper's column order",
                    ))
                for other, layout in _PACK_HELPERS.items():
                    if other != c.pack_helper and other in called:
                        out.append(Finding(
                            self.name, sf.rel_path, node.lineno,
                            f"kernel '{node.name}' (layout '{c.packed}') "
                            f"calls {other}() which packs layout "
                            f"'{layout}' — packed-column drift",
                        ))
        return out

    def _concat_elements(self, node: ast.AST) -> list[ast.expr] | None:
        """Elements of a ``torch.cat([...], dim=1)`` call."""
        if not (isinstance(node, ast.Call)
                and _terminal(node.func) in ("cat", "concatenate") and node.args):
            return None
        seq = node.args[0]
        if isinstance(seq, (ast.List, ast.Tuple)):
            return list(seq.elts)
        return None

    def _check_helper(
        self, sf: SourceFile, fn: ast.FunctionDef
    ) -> list[Finding]:
        """The pack helper's concatenate order IS the layout: element 0
        the token span, then one element per declared scalar column (the
        ragged helper wraps the block helper as its prefix)."""
        layout = kc.PACK_LAYOUTS[_PACK_HELPERS[fn.name]]
        elems = None
        for node in ast.walk(fn):
            elems = self._concat_elements(node)
            if elems is not None:
                break
        if elems is None:
            return [Finding(
                self.name, sf.rel_path, fn.lineno,
                f"pack helper {fn.name}() no longer builds its packed "
                "array with torch.cat — the unpack sites slice "
                f"layout '{layout.name}' by column offset",
            )]
        out: list[Finding] = []
        prefix_helper = None
        if isinstance(elems[0], ast.Call):
            prefix_helper = _terminal(elems[0].func)
        if prefix_helper in _PACK_HELPERS:
            prefix = kc.PACK_LAYOUTS[_PACK_HELPERS[prefix_helper]]
            scalars = layout.scalars[len(prefix.scalars):]
            if layout.scalars[: len(prefix.scalars)] != prefix.scalars:
                out.append(Finding(
                    self.name, sf.rel_path, fn.lineno,
                    f"{fn.name}() extends {prefix_helper}() but layout "
                    f"'{layout.name}' does not start with layout "
                    f"'{prefix.name}'",
                ))
            tail = elems[1:]
        else:
            scalars = layout.scalars
            tail = elems[1:]
        if len(tail) != len(scalars):
            out.append(Finding(
                self.name, sf.rel_path, fn.lineno,
                f"{fn.name}() concatenates {len(tail)} scalar column(s); "
                f"layout '{layout.name}' declares "
                f"{len(scalars)}: {list(scalars)}",
            ))
            return out
        for i, (elem, col) in enumerate(zip(tail, scalars)):
            if not _mentions(elem, col):
                out.append(Finding(
                    self.name, sf.rel_path, elem.lineno,
                    f"{fn.name}() column {layout.span}+{i + len(layout.scalars) - len(scalars)} "
                    f"should carry '{col}' (layout '{layout.name}') but "
                    "the concatenated element never references it",
                ))
        return out

    # ---- host side
    def _classify(self, col: ast.expr, span_names: tuple[str, ...]):
        """Column-index shapes a packed-array subscript may take:
        ('span', delta) | ('neg', c) | 'tokens' | 'span_slice' |
        ('bad_slice', msg) | None (unrecognized)."""
        if isinstance(col, ast.Slice):
            if col.lower is None and col.upper is None:
                return ("bad_slice", "unbounded [:] slice spans the scalar tail")
            if (isinstance(col.upper, ast.UnaryOp)
                    and isinstance(col.upper.op, ast.USub)):
                c = _int_const(col.upper.operand)
                if c is not None:
                    return ("neg_slice", c)
            t = _terminal(col.upper) if col.upper is not None else None
            if t in span_names:
                return "span_slice"
            return None
        term = _terminal(col)
        if term in span_names:
            return ("span", 0)
        if isinstance(col, ast.BinOp) and isinstance(col.op, (ast.Add, ast.Sub)):
            lt = _terminal(col.left)
            d = _int_const(col.right)
            if lt in span_names and d is not None:
                return ("span", d if isinstance(col.op, ast.Add) else -d)
        if isinstance(col, ast.UnaryOp) and isinstance(col.op, ast.USub):
            c = _int_const(col.operand)
            if c is not None:
                return ("neg", c)
        if _int_const(col) is not None or isinstance(col, ast.Name):
            return "tokens"  # absolute / loop-variable token read
        return None

    def _binding_owner(self, name: str) -> str | None:
        for col, vocab in kc.COLUMN_BINDINGS.items():
            if name in vocab:
                return col
        return None

    def _check_unpack_site(
        self, sf: SourceFile, site: kc.UnpackSite
    ) -> list[Finding]:
        fn = _find_def(sf.tree, site.function)
        if fn is None:
            return []  # coverage rule reports the vanished function
        layout = kc.PACK_LAYOUTS[site.layout]
        out: list[Finding] = []
        tainted = {
            node.targets[0].id
            for node in ast.walk(fn)
            if isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and _terminal(node.value.func) == "_block_sync"
        }
        if not tainted:
            return []

        def resolve(kind) -> str | None:
            """Scalar column a classified read lands on (None: token span)."""
            if kind == "tokens" or kind == "span_slice":
                return None
            if isinstance(kind, tuple) and kind[0] == "span":
                return layout.column_at(kind[1]) if kind[1] >= 0 else None
            if isinstance(kind, tuple) and kind[0] == "neg":
                c = kind[1]
                if c <= len(layout.scalars):
                    return layout.scalars[len(layout.scalars) - c]
                return None
            return None

        consumed: set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in tainted):
                continue
            idx = node.slice
            col = idx.elts[-1] if isinstance(idx, ast.Tuple) and idx.elts \
                else idx
            kind = self._classify(col, site.span_names)
            if kind is None:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"unrecognized packed-column index into layout "
                    f"'{site.layout}' — unpack sites must slice by the "
                    f"declared span symbol {site.span_names} or a "
                    "constant offset so drift stays checkable",
                ))
                continue
            if isinstance(kind, tuple) and kind[0] == "bad_slice":
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"{kind[1]} (layout '{site.layout}' has "
                    f"{len(layout.scalars)} scalar tail column(s))",
                ))
                continue
            if isinstance(kind, tuple) and kind[0] == "neg_slice":
                if kind[1] != len(layout.scalars):
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"token-span slice [:-{kind[1]}] but layout "
                        f"'{site.layout}' has {len(layout.scalars)} "
                        f"scalar tail column(s) "
                        f"({list(layout.scalars)}) — the span would "
                        "include scalar columns",
                    ))
                else:
                    consumed.add(layout.span_col)
                continue
            if isinstance(kind, tuple) and kind[0] == "span" \
                    and kind[1] >= 0 and resolve(kind) is None:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"column {layout.span}+{kind[1]} is past layout "
                    f"'{site.layout}' (scalar tail: "
                    f"{list(layout.scalars)}) — kernel/unpack drift",
                ))
                continue
            colname = resolve(kind)
            if colname is not None:
                consumed.add(colname)
            else:
                consumed.add(layout.span_col)
        # binding-name cross-check: `name = cast(packed[row, col])`
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            val = node.value
            while isinstance(val, ast.Call) and len(val.args) == 1 \
                    and _terminal(val.func) in _CASTS:
                val = val.args[0]
            if not (isinstance(val, ast.Subscript)
                    and isinstance(val.value, ast.Name)
                    and val.value.id in tainted):
                continue
            idx = val.slice
            col = idx.elts[-1] if isinstance(idx, ast.Tuple) and idx.elts \
                else idx
            kind = self._classify(col, site.span_names)
            if kind is None or isinstance(kind, tuple) and kind[0] in (
                "bad_slice",
            ):
                continue
            colname = resolve(kind)
            target = node.targets[0].id
            owner = self._binding_owner(target)
            if owner is not None and colname is not None and owner != colname:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"binding '{target}' reads packed column "
                    f"'{colname}' but its name belongs to column "
                    f"'{owner}' (layout '{site.layout}') — the kernel "
                    "pack order and this unpack site disagree",
                ))
            if owner is not None and colname is None and kind != "span_slice" \
                    and kind != "tokens":
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"binding '{target}' (column '{owner}') reads the "
                    f"token span of layout '{site.layout}'",
                ))
        missing = [c for c in layout.scalars if c not in consumed]
        if missing:
            out.append(Finding(
                self.name, sf.rel_path, fn.lineno,
                f"unpack site {site.function}() never consumes declared "
                f"column(s) {missing} of layout '{site.layout}' — a "
                "kernel-side layout change would go unnoticed here",
            ))
        return out

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        if kc.contracts_for_file(sf.rel_path):
            out.extend(self._check_kernel_file(sf))
        for site in kc.UNPACK_SITES:
            if site.file == sf.rel_path:
                out.extend(self._check_unpack_site(sf, site))
        return [
            f for f in out if not sf.is_suppressed(f.rule, f.line)
        ]


# ------------------------------------------------------- dtype-discipline

# Engine methods on the block dispatch/consume hot path: everything that
# builds device inputs or unpacks device outputs between block syncs.
ENGINE_HOT_FUNCS: frozenset[str] = frozenset({
    "_dispatch", "_dispatch_ragged", "_spec_step", "_consume",
    "_make_device_state", "_fold_admissions", "_block_sync",
})
_ENGINE_FILE = "gofr_tpu_torch/serving/engine.py"
_HOT_ZONE_FILES: tuple[str, ...] = kc.KERNEL_FILES + (
    "gofr_tpu_torch/ops/sampling.py",
    # the parallel plane's per-step code: collectives, ring/Ulysses, the pipeline
    "gofr_tpu_torch/parallel/collectives.py",
    "gofr_tpu_torch/parallel/context_parallel.py",
    "gofr_tpu_torch/parallel/pipeline.py",
)
_FLOAT64 = {"float64", "double"}
_INT64 = {"int64", "long"}


class DtypeDisciplineRule(Rule):
    """Hot-zone dtype hygiene for torch: no float64 (``torch.float64``,
    ``torch.double``, ``np.float64``, ``.double()``), no
    ``torch.tensor(<literal>)`` without a ``dtype`` and a ``device``, and
    no int64 (``torch.int64``/``torch.long``/``np.int64``/``.long()``) in
    a pack helper, whose output the table declares int32."""

    name = "dtype-discipline"

    def _literal_arg(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, bool)
        ):
            return True
        if isinstance(node, (ast.List, ast.Tuple)):
            return all(isinstance(e, ast.Constant) for e in node.elts)
        if isinstance(node, ast.Call) and _terminal(node.func) == "range":
            return True
        if isinstance(node, ast.ListComp):
            return True
        return False

    def _zone_nodes(self, sf: SourceFile):
        if sf.rel_path in _HOT_ZONE_FILES:
            yield from ast.walk(sf.tree)
            return
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name in ENGINE_HOT_FUNCS:
                yield from ast.walk(node)

    def _pack_helper_nodes(self, sf: SourceFile):
        if sf.rel_path not in kc.KERNEL_FILES:
            return
        for node in sf.tree.body:
            if isinstance(node, ast.FunctionDef) and node.name in _PACK_HELPERS:
                for sub in ast.walk(node):
                    yield node.name, sub

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if sf.rel_path not in _HOT_ZONE_FILES and sf.rel_path != _ENGINE_FILE:
            return []
        out: list[Finding] = []
        for node in self._zone_nodes(sf):
            if isinstance(node, ast.Attribute) and node.attr in _FLOAT64 \
                    and _dotted(node) in {
                        f"torch.{node.attr}", f"np.{node.attr}",
                        f"numpy.{node.attr}",
                    }:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"float64 dtype {_dotted(node)} in a kernel hot zone — "
                    "the kernels take bf16/f32 and the card's f64 rate is a "
                    "fraction of its f32 rate",
                ))
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and node.func.attr == "double" \
                    and not node.args:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    ".double() in a kernel hot zone — a float64 copy",
                ))
            d = _dotted(node.func)
            if d == "torch.tensor" and node.args \
                    and self._literal_arg(node.args[0]):
                kws = {kw.arg for kw in node.keywords}
                missing = [k for k in ("dtype", "device") if k not in kws]
                if missing:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"torch.tensor() of a Python literal without "
                        f"{'/'.join(missing)} in a kernel hot zone — a "
                        "default-dtype host tensor, then a copy; pass an "
                        "explicit dtype and device",
                    ))
        for helper, node in self._pack_helper_nodes(sf):
            wide = None
            if isinstance(node, ast.Attribute) and node.attr in _INT64 \
                    and _dotted(node) in {
                        f"torch.{node.attr}", f"np.{node.attr}",
                        f"numpy.{node.attr}",
                    }:
                wide = _dotted(node)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "long" and not node.args:
                wide = ".long()"
            if wide is not None:
                layout = _PACK_HELPERS[helper]
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"int64 ({wide}) in pack helper {helper}() — the "
                    f"contract table declares layout '{layout}' int32",
                ))
        return [f for f in out if not sf.is_suppressed(f.rule, f.line)]


# ------------------------------------------------------ carry-field-drift

_DTYPE_NAMES = {
    "int8", "int16", "int32", "int64", "uint8", "bool", "bool_", "float16",
    "bfloat16", "float32", "float64", "long", "int", "float", "double",
}
_DTYPE_ALIASES = {"bool_": "bool", "long": "int64", "double": "float64"}


class CarryFieldDriftRule(Rule):
    """Every DecodeState construction/update site must agree with the
    declared carry spec (:data:`kernel_contracts.DECODE_STATE_FIELDS`):
    field set, ORDER, and dtypes — a column added to the carry but missed
    at one constructor is a lint failure instead of a shape error on the
    card."""

    name = "carry-field-drift"

    _fields = tuple(n for n, _ in kc.DECODE_STATE_FIELDS)
    _dtypes = dict(kc.DECODE_STATE_FIELDS)

    def _check_classdef(self, sf: SourceFile, cls: ast.ClassDef):
        ann = [
            n.target.id
            for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
        ]
        if tuple(ann) != self._fields:
            return [Finding(
                self.name, sf.rel_path, cls.lineno,
                f"{kc.CARRY_CLASS} fields {ann} != declared carry spec "
                f"{list(self._fields)} — update kernel_contracts."
                "DECODE_STATE_FIELDS and every construction site together",
            )]
        return []

    def _check_make(self, sf: SourceFile, fn: ast.FunctionDef):
        """make_decode_state's DecodeState(...) call: per-field dtypes of
        each upload ``<upload>(value, <dtype>)``."""
        out: list[Finding] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and _terminal(node.func) == kc.CARRY_CLASS):
                continue
            for i, arg in enumerate(node.args):
                if i >= len(self._fields):
                    break
                want = self._dtypes[self._fields[i]]
                if want == "generator":
                    continue
                if isinstance(arg, ast.Call) and len(arg.args) >= 2:
                    got = _terminal(arg.args[1])
                    if got not in _DTYPE_NAMES:
                        continue
                    got = _DTYPE_ALIASES.get(got, got)
                    if got != want:
                        out.append(Finding(
                            self.name, sf.rel_path, arg.lineno,
                            f"carry field '{self._fields[i]}' uploaded "
                            f"as {got}; the declared carry dtype is "
                            f"{want}",
                        ))
        return out

    def _check_admit(self, sf: SourceFile, fn: ast.FunctionDef):
        """admit_decode_state must fold EVERY tensor field of the carry it
        updates in place (the generator rides on the object unchanged)."""
        state_param = fn.args.args[0].arg if fn.args.args else "state"
        touched = {
            n.attr
            for n in ast.walk(fn)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name)
            and n.value.id == state_param
            and n.attr in self._fields
        }
        missing = [
            f for f in self._fields
            if f not in touched and self._dtypes[f] != "generator"
        ]
        if missing:
            return [Finding(
                self.name, sf.rel_path, fn.lineno,
                f"admit_decode_state never references carry field(s) "
                f"{missing} of the state it updates — an admission would "
                "leave them stale",
            )]
        return []

    def _check_ctor_calls(self, sf: SourceFile):
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if _terminal(node.func) != kc.CARRY_CLASS:
                continue
            if any(isinstance(a, ast.Starred) for a in node.args) or any(
                kw.arg is None for kw in node.keywords
            ):
                continue  # cls(*children) / cls(**fields)
            n_args = len(node.args) + len(node.keywords)
            bad_kw = [
                kw.arg for kw in node.keywords
                if kw.arg is not None and kw.arg not in self._fields
            ]
            if n_args != len(self._fields) or bad_kw:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"{kc.CARRY_CLASS}(...) constructed with {n_args} of "
                    f"{len(self._fields)} declared carry fields"
                    + (f" (unknown: {bad_kw})" if bad_kw else "")
                    + " — every construction site must bind the full "
                    "field set explicitly (carry-field drift)",
                ))
        return out

    def _check_pending_admit(self, sf: SourceFile):
        out: list[Finding] = []
        arity = len(kc.ADMIT_TUPLE_FIELDS)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Subscript) \
                    and _terminal(node.targets[0].value) \
                    == kc.ADMIT_TUPLE_ATTR:
                if isinstance(node.value, ast.Tuple) \
                        and len(node.value.elts) != arity:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"{kc.ADMIT_TUPLE_ATTR} entry built with "
                        f"{len(node.value.elts)} element(s); the declared "
                        f"admit tuple is {list(kc.ADMIT_TUPLE_FIELDS)}",
                    ))
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Attribute) \
                    and node.target.attr == kc.ADMIT_TUPLE_ATTR:
                for sub in ast.walk(node.annotation):
                    if isinstance(sub, ast.Subscript) \
                            and _terminal(sub.value) == "tuple" \
                            and isinstance(sub.slice, ast.Tuple) \
                            and len(sub.slice.elts) != arity:
                        out.append(Finding(
                            self.name, sf.rel_path, node.lineno,
                            f"{kc.ADMIT_TUPLE_ATTR} annotated as a "
                            f"{len(sub.slice.elts)}-tuple; the declared "
                            f"admit tuple has {arity} fields "
                            f"{list(kc.ADMIT_TUPLE_FIELDS)}",
                        ))
        return out

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        if sf.rel_path == kc.CARRY_FILE:
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef) \
                        and node.name == kc.CARRY_CLASS:
                    out.extend(self._check_classdef(sf, node))
                if isinstance(node, ast.FunctionDef):
                    if node.name == "make_decode_state":
                        out.extend(self._check_make(sf, node))
                    if node.name == "admit_decode_state":
                        out.extend(self._check_admit(sf, node))
        out.extend(self._check_ctor_calls(sf))
        if sf.rel_path == kc.ADMIT_TUPLE_FILE:
            out.extend(self._check_pending_admit(sf))
        return [f for f in out if not sf.is_suppressed(f.rule, f.line)]


# ------------------------------------------------------ spec-rank-mismatch

_SHAPE_COMMENT = re.compile(r"#\s*\[([^\]]+)\]")
#: the rank each of ``parallel.sharding.activation_spec``'s kinds places
_ACTIVATION_RANKS = {"tokens": 2, "hidden": 3, "logits": 3}


def _spec_arity(node: ast.AST | None, env: dict[str, int]) -> int | None:
    """Arity of a placement expression: ``P(...)``/``PartitionSpec(...)``,
    ``NamedSharding(mesh, P(...))``, ``named_sharding(mesh, *axes)``,
    ``activation_spec("kind")`` or a bare kind, a callable ``lambda mesh:
    <one of those>``, or a name bound to one (None: unresolvable)."""
    if isinstance(node, ast.Lambda):
        return _spec_arity(node.body, env)
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _ACTIVATION_RANKS.get(node.value)
    if not isinstance(node, ast.Call) or any(isinstance(a, ast.Starred) for a in node.args):
        return None
    term = _terminal(node.func)
    if term in ("P", "PartitionSpec"):
        return len(node.args)
    if term == "NamedSharding" and len(node.args) == 2:
        return _spec_arity(node.args[1], env)
    if term == "named_sharding" and node.args:
        return len(node.args) - 1
    if term == "activation_spec" and node.args:
        return _spec_arity(node.args[0], env)
    return None


def _declared_rank(lines: list[str], arg: ast.arg) -> int | None:
    """Rank declared by a trailing ``# [B, S, H, D]`` comment on the
    parameter's line."""
    ln = getattr(arg, "lineno", None)
    if ln is None or ln > len(lines):
        return None
    m = _SHAPE_COMMENT.search(lines[ln - 1])
    if m is None:
        return None
    return len([p for p in m.group(1).split(",") if p.strip()])


def _positional_args(fn: ast.FunctionDef | ast.Lambda) -> list[ast.arg]:
    return fn.args.posonlyargs + fn.args.args


class SpecRankRule(Rule):
    """Placement plumbing consistency over the port's mesh, the
    reference's ``shard_map`` checks restated:

    - a mapped call, ``client.compile(name, fn, *examples,
      in_shardings=..., out_shardings=...)`` (``datasource/tpu``): the
      in_shardings' count against ``fn``'s positional arity (less what a
      ``functools.partial`` bound) and against the examples given,
      out_shardings' count against the tuple ``fn`` returns, and each
      ``P(...)``'s arity against the rank its parameter declares (a
      trailing ``# [B, S, H, D]`` comment);
    - a higher-order wrapper that calls its function parameter with N
      positional arrays (``context_parallel._global_view``): every body
      handed to it in the file must take N;
    - ``local_index``/``shard_leaf``/``with_constraint``: the spec's
      arity against the declared rank of what it places;
    - ``<model>_sharding_rules``: each rule's ``P(...)`` against the rank
      of every leaf of ``models/<model>.py``'s ``init_params`` it is the
      first match for (cross-file).

    A spec shorter than the rank is legal (trailing dimensions
    replicate); an unresolvable spec or body is skipped."""

    name = "spec-rank-mismatch"
    cross_file = True

    def __init__(self) -> None:
        self._tables: dict[str, list[tuple[str, int, str, int]]] = {}  # model -> rules
        self._leaves: dict[str, dict[str, int]] = {}  # model -> {leaf path: rank}

    @staticmethod
    def _resolve(defs: dict, assigns: dict, node: ast.AST) -> tuple[Any, int]:
        """The function a name/partial/lambda resolves to in this file,
        and how many of its positional parameters a partial bound."""
        bound = 0
        for _ in range(4):
            if isinstance(node, ast.Lambda):
                return node, bound
            if isinstance(node, ast.Name):
                if node.id in defs:
                    return defs[node.id], bound
                node = assigns.get(node.id)
                if node is None:
                    return None, bound
                continue
            if isinstance(node, ast.Call) and _terminal(node.func) == "partial" and node.args:
                bound += len(node.args) - 1
                node = node.args[0]
                continue
            return None, bound
        return None, bound

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        scan = _SpecScan()
        scan.visit(sf.tree)
        out: list[Finding] = []
        lines = sf.source.splitlines()
        for call in scan.compiles:
            self._mapped_call(sf, lines, scan, call, out)
        self._plumbing(sf, scan, out)
        self._placements(sf, lines, scan, out)
        self._collect_tables(sf, scan)
        return [f for f in out if not sf.is_suppressed(f.rule, f.line)]

    # -- mapped calls: compile(name, fn, *examples, in_/out_shardings=) ------
    def _mapped_call(self, sf: SourceFile, lines: list[str], scan: "_SpecScan",
                     node: ast.Call, out: list[Finding]) -> None:
        env = scan.env
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        in_sh, out_sh = kw.get("in_shardings"), kw.get("out_shardings")
        in_sh = in_sh.body if isinstance(in_sh, ast.Lambda) else in_sh
        out_sh = out_sh.body if isinstance(out_sh, ast.Lambda) else out_sh
        inner, bound = self._resolve(scan.defs, scan.assigns, node.args[1])
        name = getattr(inner, "name", "<lambda>")
        examples = node.args[2:]
        n_in = None
        if isinstance(in_sh, (ast.Tuple, ast.List)):
            n_in = len(in_sh.elts)
        elif in_sh is not None and _spec_arity(in_sh, env) is not None:
            n_in = 1
        if inner is not None and n_in is not None:
            n_pos = len(_positional_args(inner)) - bound
            if n_pos != n_in:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"compile in_shardings has {n_in} spec(s) but '{name}' takes "
                    f"{n_pos} positional array(s) — the placement would mis-shard "
                    "or fail only at run time",
                ))
            elif isinstance(in_sh, (ast.Tuple, ast.List)):
                params = _positional_args(inner)
                for i, spec in enumerate(in_sh.elts):
                    arity = _spec_arity(spec, env)
                    rank = _declared_rank(lines, params[i + bound]) \
                        if i + bound < len(params) else None
                    if arity is not None and rank is not None and arity > rank:
                        out.append(Finding(
                            self.name, sf.rel_path, spec.lineno,
                            f"in_shardings[{i}] has {arity} axes but '{name}' declares "
                            f"its parameter as rank {rank} — PartitionSpec arity "
                            "exceeds the array rank",
                        ))
        if inner is not None and out_sh is not None:
            rets = [inner.body] if isinstance(inner, ast.Lambda) else [
                n.value for n in ast.walk(inner)
                if isinstance(n, ast.Return) and n.value is not None]
            arities = {len(r.elts) if isinstance(r, ast.Tuple) else 1 for r in rets}
            if len(arities) == 1:
                r_arity = arities.pop()
                o_arity = len(out_sh.elts) if isinstance(out_sh, (ast.Tuple, ast.List)) else 1
                if r_arity != o_arity:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"compile out_shardings declares {o_arity} output spec(s) but "
                        f"'{name}' returns {r_arity} value(s) — the outputs' placement "
                        "would not match",
                    ))
        if isinstance(in_sh, (ast.Tuple, ast.List)) \
                and not any(isinstance(a, ast.Starred) for a in examples) \
                and len(examples) != len(in_sh.elts):
            out.append(Finding(
                self.name, sf.rel_path, node.lineno,
                f"compile given {len(examples)} example array(s) but in_shardings "
                f"declares {len(in_sh.elts)} — argument/spec drift",
            ))

    # -- higher-order wrappers: W(fn, ...) calls fn(a, b, ...) ---------------
    def _plumbing(self, sf: SourceFile, scan: "_SpecScan", out: list[Finding]) -> None:
        counts: dict[tuple[int, str], set[int]] = {}  # (id of W, param) -> arities
        for call, stack in scan.name_calls:
            if any(isinstance(a, ast.Starred) for a in call.args):
                continue
            for fn in stack:
                if call.func.id in fn.param_names:
                    counts.setdefault((id(fn.node), call.func.id), set()).add(len(call.args))
        wrappers: dict[str, list[tuple[int, str, int]]] = {}
        for fn in scan.defs.values():
            for i, p in enumerate(a.arg for a in _positional_args(fn)):
                arities = counts.get((id(fn), p), ())
                if len(arities) == 1:
                    wrappers.setdefault(fn.name, []).append((i, p, next(iter(arities))))
        for node, _ in scan.name_calls:
            if node.func.id not in wrappers:
                continue
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            for i, p, n_args in wrappers[node.func.id]:
                arg = node.args[i] if i < len(node.args) else kw.get(p)
                if arg is None or isinstance(arg, ast.Lambda):
                    continue
                body, bound = self._resolve(scan.defs, scan.assigns, arg)
                if not isinstance(body, ast.FunctionDef) or body.args.vararg is not None:
                    continue
                params = _positional_args(body)
                total = len(params) - bound
                required = total - len(body.args.defaults)
                if not required <= n_args <= total:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"'{node.func.id}' calls its '{p}' with {n_args} positional "
                        f"array(s) but '{body.name}' takes {total} — the wrapper's "
                        "plumbing and the body it maps have drifted",
                    ))

    # -- local_index / shard_leaf / with_constraint ------------------------
    def _placements(self, sf: SourceFile, lines: list[str], scan: "_SpecScan",
                    out: list[Finding]) -> None:
        ranks_of: dict[int, dict[str, int]] = {}
        for node, fn in scan.placers:
            if fn is None:
                ranks = {}
            elif id(fn) not in ranks_of:
                ranks = ranks_of[id(fn)] = {
                    a.arg: r for a in _positional_args(fn) + fn.args.kwonlyargs
                    if (r := _declared_rank(lines, a)) is not None}
            else:
                ranks = ranks_of[id(fn)]
            term = _terminal(node.func)
            if term == "local_index":
                shape, spec = node.args[0], node.args[1]
                if isinstance(shape, ast.Tuple):
                    rank, what = len(shape.elts), "the shape"
                elif isinstance(shape, ast.Attribute) and shape.attr == "shape" \
                        and isinstance(shape.value, ast.Name):
                    rank, what = ranks.get(shape.value.id), f"'{shape.value.id}'"
                else:
                    continue
            elif isinstance(node.args[0], ast.Name):
                spec = node.args[1] if term == "shard_leaf" else (
                    node.args[2] if len(node.args) > 2 else None)
                rank, what = ranks.get(node.args[0].id), f"'{node.args[0].id}'"
            else:
                continue
            arity = _spec_arity(spec, scan.env)
            if rank is not None and arity is not None and arity > rank:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"{term}: the spec has {arity} axes but {what} is declared rank "
                    f"{rank} — PartitionSpec arity exceeds the array rank",
                ))

    # -- <model>_sharding_rules against models/<model>.py init_params -------
    def _collect_tables(self, sf: SourceFile, scan: "_SpecScan") -> None:
        for fn in scan.rules_fns:
            model = fn.name[: -len("_sharding_rules")]
            entries = []
            for n in ast.walk(fn):
                if isinstance(n, ast.Tuple) and len(n.elts) == 2 \
                        and isinstance(n.elts[0], ast.Constant) \
                        and isinstance(n.elts[0].value, str):
                    arity = _spec_arity(n.elts[1], {})
                    if arity is not None:
                        entries.append((n.lineno, n.col_offset, n.elts[0].value, arity))
            self._tables[model] = [(pat, arity, sf.rel_path, line)
                                   for line, _, pat, arity in sorted(entries)]
        parts = sf.rel_path.split("/")
        if len(parts) >= 2 and parts[-2] == "models" and "init_params" in scan.defs:
            self._leaves[parts[-1][:-3]] = _leaf_ranks(scan.defs["init_params"])

    def finalize(self) -> list[Finding]:
        out: list[Finding] = []
        for model, rules in sorted(self._tables.items()):
            for leaf, rank in sorted(self._leaves.get(model, {}).items()):
                for pat, arity, path, line in rules:
                    if re.search(pat, leaf):
                        if arity > rank:
                            out.append(Finding(
                                self.name, path, line,
                                f"{model}_sharding_rules: rule {pat!r} gives '{leaf}' "
                                f"{arity} axes but models/{model}.py's init_params makes it "
                                f"rank {rank} — PartitionSpec arity exceeds the array rank",
                            ))
                        break
        return out


_PLACERS = ("local_index", "shard_leaf", "with_constraint")


class _Enclosing:
    """A function on the scan's stack, with its positional parameter names."""

    __slots__ = ("node", "param_names")

    def __init__(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self.node = node
        self.param_names = {a.arg for a in _positional_args(node)}


class _SpecScan(ast.NodeVisitor):
    """One walk of a file for the spec-rank rule: its defs, single-name
    assignments (and the placements among them), ``compile(...,
    in_shardings=/out_shardings=)`` calls, calls of a bare name with the
    functions around them, placement calls with the innermost function,
    and the ``*_sharding_rules`` tables."""

    def __init__(self) -> None:
        self.defs: dict[str, ast.FunctionDef] = {}
        self.assigns: dict[str, ast.AST] = {}
        self.env: dict[str, int] = {}
        self.compiles: list[ast.Call] = []
        self.name_calls: list[tuple[ast.Call, tuple]] = []
        self.placers: list[tuple[ast.Call, Any]] = []
        self.rules_fns: list[ast.FunctionDef] = []
        self._stack: list[_Enclosing] = []

    def _visit_func(self, node) -> None:
        if isinstance(node, ast.FunctionDef):
            self.defs.setdefault(node.name, node)
            if node.name.endswith("_sharding_rules"):
                self.rules_fns.append(node)
        self._stack.append(_Enclosing(node))
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            self.assigns.setdefault(name, node.value)
            arity = _spec_arity(node.value, {})
            if arity is not None:
                self.env.setdefault(name, arity)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        term = _terminal(node.func)
        if term == "compile" and len(node.args) >= 2 and any(
                k.arg in ("in_shardings", "out_shardings") for k in node.keywords):
            self.compiles.append(node)
        if isinstance(node.func, ast.Name):
            self.name_calls.append((node, tuple(self._stack)))
        if term in _PLACERS and len(node.args) >= 2:
            self.placers.append((node, self._stack[-1].node if self._stack else None))
        self.generic_visit(node)


def _leaf_ranks(init: ast.FunctionDef) -> dict[str, int]:
    """{leaf path: rank} of the dict literals an ``init_params`` builds:
    a leaf's rank is the length of the first tuple literal its value
    passes to a call (``winit((L, D, H * Dh), D)``)."""
    nested = {id(v) for n in ast.walk(init) if isinstance(n, ast.Dict)
              for v in n.values if isinstance(v, ast.Dict)}
    out: dict[str, int] = {}

    def leaves(d: ast.Dict, prefix: str) -> None:
        for k, v in zip(d.keys, d.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                continue
            path = f"{prefix}{k.value}"
            if isinstance(v, ast.Dict):
                leaves(v, path + "/")
                continue
            for n in ast.walk(v):
                if isinstance(n, ast.Call):
                    shape = next((a for a in n.args if isinstance(a, ast.Tuple)), None)
                    if shape is not None:
                        out[path] = len(shape.elts)
                        break

    for n in ast.walk(init):
        if isinstance(n, ast.Dict) and id(n) not in nested:
            leaves(n, "")
    return out


# ------------------------------------------------- kernel-contract-coverage


class KernelContractCoverageRule(Rule):
    """The zone-drift audit for the contract table: every public
    module-level function in :data:`kernel_contracts.KERNEL_FILES` needs a
    declared contract whose params and static set match its signature, or
    a :data:`kernel_contracts.HOST_HELPERS` entry; contracts, helper
    entries and unpack sites pointing at vanished functions fail too."""

    name = "kernel-contract-coverage"
    cross_file = True

    def __init__(
        self,
        anchor: str | None = _ENGINE_FILE,
        anchor_symbol: str = "ServingEngine",
    ) -> None:
        # a fixture tree can materialize files NAMED like the kernel files;
        # requiring the anchor file to also DEFINE the marker symbol pins
        # the whole rule to the real tree (deadlinecheck's ZoneDriftRule
        # gates the same way). Tests pass anchor=None to un-gate.
        self._anchor = anchor
        self._anchor_symbol = anchor_symbol
        self._anchor_seen = anchor is None
        self._buffered: list[Finding] = []
        self._seen_kernel_files: dict[str, set[str]] = {}
        self._seen_defs: dict[str, set[str]] = {}

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if (self._anchor is not None
                and sf.rel_path.endswith(self._anchor)
                and any(isinstance(n, ast.ClassDef)
                        and n.name == self._anchor_symbol
                        for n in sf.tree.body)):
            self._anchor_seen = True
        interesting = sf.rel_path in kc.KERNEL_FILES or any(
            u.file == sf.rel_path for u in kc.UNPACK_SITES
        )
        if not interesting:
            return []
        self._seen_defs[sf.rel_path] = {
            n.name for n in ast.walk(sf.tree)
            if isinstance(n, ast.FunctionDef)
        }
        if sf.rel_path not in kc.KERNEL_FILES:
            return []
        out: list[Finding] = []
        contracts = kc.contracts_for_file(sf.rel_path)
        defined: set[str] = set()
        for node in sf.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            defined.add(node.name)
            c = contracts.get(node.name)
            if c is None:
                if node.name.startswith("_"):
                    continue  # private helpers: contracts only where declared
                helper = kc.HOST_HELPERS.get(node.name)
                if helper is not None and helper[0] == sf.rel_path:
                    continue
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"public function '{node.name}' in a kernel file has no "
                    "declared contract — add it to kernel_contracts.KERNELS "
                    "(params, in-place set, packed layout, return "
                    "signatures), or to HOST_HELPERS with its reason",
                ))
                continue
            params = tuple(_all_params(node))
            if params != c.params:
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"kernel '{node.name}' signature {list(params)} != "
                    f"declared contract params {list(c.params)}",
                ))
            static = _static_params(node)
            if static != set(c.static):
                out.append(Finding(
                    self.name, sf.rel_path, node.lineno,
                    f"kernel '{node.name}' takes Python-value args "
                    f"{sorted(static)} but the contract declares static "
                    f"{sorted(c.static)} — signature drift",
                ))
            for ret in c.returns:
                if ret.like is not None and ret.like not in c.params:
                    out.append(Finding(
                        self.name, sf.rel_path, node.lineno,
                        f"contract '{node.name}' output '{ret.name}' is "
                        f"declared like '{ret.like}', which is no parameter",
                    ))
        self._seen_kernel_files[sf.rel_path] = defined
        # buffered until finalize: findings only count on the real tree
        self._buffered.extend(
            f for f in out if not sf.is_suppressed(f.rule, f.line)
        )
        return []

    def finalize(self) -> list[Finding]:
        if not self._anchor_seen:
            self._buffered = []
            self._seen_kernel_files = {}
            self._seen_defs = {}
            return []
        out: list[Finding] = list(self._buffered)
        self._buffered = []
        for rel, defined in self._seen_kernel_files.items():
            for c in kc.KERNELS:
                if c.file == rel and c.name not in defined:
                    out.append(Finding(
                        self.name, rel, 1,
                        f"contract table entry '{c.name}' matches no "
                        f"module-level def in {rel} — stale contract (the "
                        "kernel moved or was renamed; update "
                        "kernel_contracts.KERNELS)",
                    ))
            for name, (file, _why) in kc.HOST_HELPERS.items():
                if file == rel and name not in defined:
                    out.append(Finding(
                        self.name, rel, 1,
                        f"HOST_HELPERS entry '{name}' matches no "
                        f"module-level def in {rel} — stale entry",
                    ))
        for site in kc.UNPACK_SITES:
            defs = self._seen_defs.get(site.file)
            if defs is not None and site.function not in defs:
                out.append(Finding(
                    self.name, site.file, 1,
                    f"declared unpack site '{site.function}' no longer "
                    f"exists in {site.file} — kernel_contracts."
                    "UNPACK_SITES drifted from the tree",
                ))
        self._seen_kernel_files = {}
        self._seen_defs = {}
        self._anchor_seen = self._anchor is None
        return out


def kernelcheck_rules() -> list[Rule]:
    return [
        PackLayoutRule(),
        DtypeDisciplineRule(),
        CarryFieldDriftRule(),
        SpecRankRule(),
        KernelContractCoverageRule(),
    ]


# ------------------------------------------------ static <-> runtime twin


def _eval_dim(expr: str, env: dict[str, int]) -> int | None:
    try:
        return int(eval(expr, {"__builtins__": {}}, dict(env)))  # noqa: S307
    except Exception:
        return None


def check_kernel_table(runtime: dict, contracts=None) -> list[str]:
    """Verify a runtime export (:mod:`gofr_tpu_torch.analysis.kerneltrace`
    — the CPU matrix or the live engine observer) against the static
    contract table. Returns human-readable divergences; empty
    means the runtime twin and the committed table agree."""
    contracts = contracts if contracts is not None else kc.CONTRACTS
    div: list[str] = []
    exercised: set[str] = set()
    for v in runtime.get("violations", []):
        div.append(f"runtime violation: {v}")
    for case in runtime.get("cases", []):
        name = case.get("kernel", "?")
        label = f"{name}[{case.get('variant', '?')}]"
        c = contracts.get(name)
        if c is None:
            div.append(
                f"{label}: observed kernel has no declared contract "
                "(kernel_contracts.KERNELS)"
            )
            continue
        exercised.add(name)
        env: dict[str, int] = {}
        for k, v in case.get("statics", {}).items():
            if isinstance(v, bool):
                continue
            if isinstance(v, int):
                env[k] = v
        inputs = case.get("inputs", {})
        for param, sym in c.arg_shapes:
            sig = inputs.get(param)
            if not sig or len(sig.get("leaves", [])) != 1:
                continue
            dims = sig["leaves"][0][0]
            syms = [s.strip() for s in sym.split(",")]
            if len(syms) != len(dims):
                div.append(
                    f"{label}: input '{param}' rank {len(dims)} != "
                    f"declared '{sym}'"
                )
                continue
            for s, d in zip(syms, dims):
                if s == "_":
                    continue
                if s.isdigit():
                    if int(s) != d:
                        div.append(
                            f"{label}: input '{param}' dim {s} observed "
                            f"as {d}"
                        )
                elif s in env:
                    if env[s] != d:
                        div.append(
                            f"{label}: dim symbol {s} bound to {env[s]} "
                            f"but input '{param}' carries {d}"
                        )
                else:
                    env[s] = d
        outs = case.get("outputs", [])
        if len(outs) != len(c.returns):
            div.append(
                f"{label}: kernel returned {len(outs)} output(s); the "
                f"contract declares {len(c.returns)}"
            )
            continue
        for ret, got in zip(c.returns, outs):
            if ret.like:
                want = inputs.get(ret.like)
                if want is None:
                    div.append(
                        f"{label}: passthrough output '{ret.name}' has "
                        f"no recorded input '{ret.like}' to compare "
                        "against"
                    )
                elif got != want:
                    div.append(
                        f"{label}: output '{ret.name}' signature {got} "
                        f"!= its declared twin input '{ret.like}' "
                        f"{want} — in-place carry drift"
                    )
                continue
            leaves = got.get("leaves", [])
            if len(leaves) != 1:
                div.append(
                    f"{label}: output '{ret.name}' is a "
                    f"{len(leaves)}-leaf pytree; the contract declares "
                    "one array"
                )
                continue
            shape, dtype = leaves[0]
            exprs = [s.strip() for s in (ret.shape or "").split(",")]
            if len(exprs) != len(shape):
                div.append(
                    f"{label}: output '{ret.name}' rank {len(shape)} != "
                    f"declared '{ret.shape}'"
                )
                continue
            for expr, d in zip(exprs, shape):
                want_d = _eval_dim(expr, env)
                if want_d is None:
                    if expr.isidentifier():
                        env[expr] = d  # bind-on-first-use, then pinned
                        continue
                    div.append(
                        f"{label}: output '{ret.name}' dim '{expr}' "
                        "uses symbols the case never bound"
                    )
                elif want_d != d:
                    div.append(
                        f"{label}: output '{ret.name}' dim '{expr}' = "
                        f"{want_d} by the contract, observed {d}"
                    )
            if ret.dtype is not None and dtype != ret.dtype:
                div.append(
                    f"{label}: output '{ret.name}' dtype {dtype}; the "
                    f"contract declares {ret.dtype}"
                )
    if runtime.get("mode") == "matrix":
        # the CPU matrix runs EVERY entry (the reference's eval_shape matrix
        # could not run the ops-level Pallas wrappers abstractly)
        required = {k.name for k in contracts.values()}
        for missing in sorted(required - exercised):
            div.append(
                f"matrix coverage: contract entry '{missing}' was never "
                "exercised by the CPU matrix"
            )
    return div
