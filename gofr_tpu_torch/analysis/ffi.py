"""FFI signature cross-checker: the ``extern "C"`` entries of the port's
CUDA sources (``gofr_tpu_torch/csrc/*.cu``) against the ctypes table that
loads them (``gofr_tpu_torch/_build.py`` ``SIGNATURES``).

The kernels' only boundary with Python is that table: hand-written
``argtypes`` lists, 14 to 20 arguments long, one per ``extern "C"``
entry. A dropped or retyped argument there shifts every argument after it:
the kernel reads a pointer as a length, or a length as a pointer, and
corrupts memory on the card, on whatever path happens to run. This check
catches it at lint time, for every entry:

- every ``extern "C"`` function in ``csrc/<lib>.cu`` must appear under
  ``SIGNATURES["<lib>"]`` with the same name, the same number of
  arguments and the same canonical types (``ffi-mismatch``, or
  ``ffi-unbound`` when it has no binding);
- every binding must still exist in C (``ffi-stale``);
- every entry returns ``int`` (its launch's ``cudaError_t``), as ctypes
  is told (``restype``, or ctypes' default ``c_int``).

Both sides are normalized to canonical tokens (``i32``, ``i64``,
``f32``, ``f64``, ``ptr``, ``p_i32``, ``p_f32``, ...) so the comparison is
exact, not textual. ``_build.py`` is read as source (no import), so a copy
of the tree can be checked.

The port's counterpart of ``gofr_tpu/analysis/ffi.py``, which checks
``native/``'s TUs against ``gofr_tpu/native/__init__.py``.
"""

from __future__ import annotations

import ast
import os
import re

from gofr_tpu_torch.analysis.core import Finding

BUILD_REL = "gofr_tpu_torch/_build.py"
CSRC_REL = "gofr_tpu_torch/csrc"

_EXPORT_RE = re.compile(
    r'extern\s+"C"\s+(?:__host__\s+)?(?P<ret>(?:const\s+)?[\w:]+\s*\**)\s*'
    r"(?P<name>\w+)\s*\((?P<args>[^)]*)\)\s*[{;]",
    re.DOTALL,
)

_C_SCALARS = {
    "int": "i32", "int32_t": "i32", "unsigned": "u32", "uint32_t": "u32",
    "long long": "i64", "int64_t": "i64", "size_t": "u64",
    "float": "f32", "double": "f64", "void": "void",
    "cudaStream_t": "ptr", "cudaError_t": "i32",
}
_C_POINTERS = {
    "char": "cstr", "int": "p_i32", "int32_t": "p_i32", "int64_t": "p_i64",
    "float": "p_f32", "void": "ptr",
}
_PY_TYPES = {
    "c_int": "i32", "c_int32": "i32", "c_uint": "u32", "c_uint32": "u32",
    "c_int64": "i64", "c_longlong": "i64", "c_size_t": "u64",
    "c_float": "f32", "c_double": "f64", "c_void_p": "ptr", "c_char_p": "cstr",
}


def _canon_c_type(text: str) -> str:
    t = re.sub(r"\b(const|volatile|__restrict__|restrict)\b", " ", text)
    t = re.sub(r"\s+", " ", t).strip()
    is_ptr = t.endswith("*")
    base = t.rstrip("*").strip()
    if is_ptr:
        return _C_POINTERS.get(base, "ptr")  # struct pointers -> opaque
    return _C_SCALARS.get(base, f"?{base}")


def _split_c_args(args: str) -> list[str]:
    args = re.sub(r"\s+", " ", args).strip()
    if not args or args == "void":
        return []
    out = []
    for piece in args.split(","):
        piece = piece.strip()
        # drop the parameter name: the type is everything up to the last
        # identifier ("const void* q" / "int B")
        m = re.match(r"^(?P<type>.*?[\w*])\s*\b\w+$", piece)
        typ = m.group("type") if m and m.group("type").strip() else piece
        out.append(_canon_c_type(typ))
    return out


def parse_c_exports(path: str) -> dict[str, tuple[str, list[str], int]]:
    """``{symbol: (restype, [argtypes], line)}`` for one CUDA source."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    # blank comments (keeping newlines, so lines still count) so that a
    # commented-out entry does not register
    def blank(m: re.Match) -> str:
        return re.sub(r"[^\n]", " ", m.group(0))

    stripped = re.sub(r"/\*.*?\*/", blank, source, flags=re.DOTALL)
    stripped = re.sub(r"//[^\n]*", blank, stripped)
    exports: dict[str, tuple[str, list[str], int]] = {}
    for m in _EXPORT_RE.finditer(stripped):
        line = stripped.count("\n", 0, m.start()) + 1
        exports[m.group("name")] = (
            _canon_c_type(m.group("ret")), _split_c_args(m.group("args")), line,
        )
    return exports


def _canon_py_expr(node: ast.expr, aliases: dict[str, str]) -> str:
    if isinstance(node, ast.Name):
        return aliases.get(node.id, _PY_TYPES.get(node.id, f"?{node.id}"))
    if isinstance(node, ast.Attribute):  # ctypes.c_int
        return _PY_TYPES.get(node.attr, f"?{node.attr}")
    if isinstance(node, ast.Call):  # ctypes.POINTER(ctypes.c_int32)
        fname = (
            node.func.attr if isinstance(node.func, ast.Attribute)
            else node.func.id if isinstance(node.func, ast.Name) else ""
        )
        if fname == "POINTER" and node.args:
            inner = _canon_py_expr(node.args[0], aliases)
            return f"p_{inner}"
    return "?expr"


def parse_signatures(build_py: str) -> tuple[dict[str, dict[str, tuple[list[str], int]]], str]:
    """``({library: {symbol: ([argtypes], line)}}, restype)`` read from the
    module-level ``SIGNATURES`` table of ``_build.py`` and the ``restype``
    its loader assigns (ctypes' default ``c_int`` when it assigns none)."""
    with open(build_py, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=build_py)
    aliases: dict[str, str] = {}
    table: ast.Dict | None = None
    restype = "i32"
    for stmt in tree.body:
        targets: list[ast.expr]
        if isinstance(stmt, ast.Assign):
            targets, value = list(stmt.targets), stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Tuple) and isinstance(value, ast.Tuple):
                for t, v in zip(tgt.elts, value.elts):  # _P, _I = c_void_p, c_int
                    if isinstance(t, ast.Name):
                        aliases[t.id] = _canon_py_expr(v, aliases)
            elif isinstance(tgt, ast.Name):
                if tgt.id == "SIGNATURES" and isinstance(value, ast.Dict):
                    table = value
                elif isinstance(value, (ast.Attribute, ast.Name, ast.Call)):
                    aliases[tgt.id] = _canon_py_expr(value, aliases)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Attribute) and t.attr == "restype" for t in node.targets
        ):
            restype = _canon_py_expr(node.value, aliases)
    out: dict[str, dict[str, tuple[list[str], int]]] = {}
    if table is None:
        return out, restype
    for key, value in zip(table.keys, table.values):
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            continue
        entries: dict[str, tuple[list[str], int]] = {}
        if isinstance(value, ast.List):
            for entry in value.elts:
                if not (isinstance(entry, ast.Tuple) and len(entry.elts) == 2):
                    continue
                name, args = entry.elts
                if not (isinstance(name, ast.Constant) and isinstance(name.value, str)):
                    continue
                argtypes = (
                    [_canon_py_expr(a, aliases) for a in args.elts]
                    if isinstance(args, ast.List) else ["?expr"]
                )
                entries[name.value] = (argtypes, name.lineno)
        out[key.value] = entries
    return out, restype


def check_ffi(repo_root: str) -> list[Finding]:
    """Cross-check every ``csrc/*.cu`` against ``_build.SIGNATURES``."""
    build_py = os.path.join(repo_root, BUILD_REL)
    csrc = os.path.join(repo_root, CSRC_REL)
    if not os.path.exists(build_py):
        return [Finding("ffi-layout", BUILD_REL, 0, "kernel loader not found")]
    if not os.path.isdir(csrc):
        return [Finding("ffi-layout", CSRC_REL, 0, "kernel source directory missing")]
    signatures, restype = parse_signatures(build_py)
    findings: list[Finding] = []
    libs = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    for lib in libs:
        c_rel = f"{CSRC_REL}/{lib}.cu"
        c_syms = parse_c_exports(os.path.join(repo_root, c_rel))
        py_syms = signatures.get(lib)
        for name, (c_res, c_args, c_line) in sorted(c_syms.items()):
            if py_syms is None or name not in py_syms:
                where = (f'SIGNATURES["{lib}"]' if py_syms is not None
                         else f'SIGNATURES (no "{lib}" entry)')
                findings.append(Finding(
                    "ffi-unbound", c_rel, c_line,
                    f"{name}: exported but not declared in {where} — "
                    "_build.library() never sets its argtypes, so ctypes "
                    "passes every argument unchecked",
                ))
                continue
            py_args, py_line = py_syms[name]
            if c_res != restype:
                findings.append(Finding(
                    "ffi-mismatch", c_rel, c_line,
                    f"{name}: returns {c_res}, but ctypes reads {restype} "
                    "(every entry returns its launch's cudaError_t as int)",
                ))
            if py_args != c_args:
                findings.append(Finding(
                    "ffi-mismatch", BUILD_REL, py_line,
                    f"{name}: {len(py_args)} argtypes {py_args} != C's "
                    f"{len(c_args)} {c_args} ({c_rel}:{c_line})",
                ))
        for name, (_, py_line) in sorted((py_syms or {}).items()):
            if name not in c_syms:
                findings.append(Finding(
                    "ffi-stale", BUILD_REL, py_line,
                    f"{name}: declared in SIGNATURES[\"{lib}\"] but not "
                    f"exported by {c_rel} — the load raises at getattr",
                ))
    for lib, entries in sorted(signatures.items()):
        if lib not in libs:
            for name, (_, py_line) in sorted(entries.items()):
                findings.append(Finding(
                    "ffi-stale", BUILD_REL, py_line,
                    f"{name}: declared in SIGNATURES[\"{lib}\"] but "
                    f"{CSRC_REL}/{lib}.cu does not exist",
                ))
    return findings
