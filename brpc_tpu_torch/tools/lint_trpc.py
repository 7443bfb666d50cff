#!/usr/bin/env python3
"""lint_trpc — the port's native boundary and wire tables held against
cpp/ and csrc/.  Port of tools/lint_trpc.py.

    python -m brpc_tpu_torch.tools.lint_trpc

Prints `lint_trpc: clean` and exits 0, or prints one `path:line: [rule]
msg` line per violation and exits 1.  It reads the sources as text and
with `ast` and imports none of them: only the standard library loads.

Rules over cpp/, which both packages share — the same files, the same
meaning and the same findings as the reference's:

  flag-validator   every `trpc_*` Flag::define_* installs a validator
                   (set_validator / set_int_range / set_reloadable(false))
                   within 30 lines;
  var-help         every `expose(` passes a HELP description;
  tail-group       the `// tail-group N (name)` markers of encode_meta and
                   decode_meta are consecutive from 1 and identical;
  tuner-rule       every `tuner-knob (name)` marker sits on its knob's
                   assignment and names a defined, reloadable flag; every
                   `tuner-input` var is exposed with a HELP in cpp/;
  atomic-comment   every relaxed/acquire atomic of the socket, messenger,
                   qos, stripe, rma and kv hot paths carries a comment.

Rules over the port's side of the boundary, each reported at the port's
file (the fix goes there: cpp/ is shared, and the reference holds its own
side):

  capi-gil         the native runtime and the CUDA libraries load through
                   ctypes.CDLL (which releases the GIL around each call),
                   never PyDLL; every `trpc_*` the port touches on the
                   library has an entry in rpc/_lib.py's `_SIGNATURES`, and
                   every entry names an `extern "C"` function of
                   cpp/capi/*.cc with as many argtypes as the prototype
                   has parameters and the same slot widths: a pointer is
                   c_void_p, c_char_p or POINTER(...), a size_t, int64_t,
                   uint64_t or long is a 64-bit ctypes integer, a void
                   return is None, and a narrow C int is a narrow ctypes
                   int.  Every `extern "C"` of csrc/*.cu that Python
                   reaches through `_kernels.load(...)` must exist and get
                   the same checks where it is loaded, with argtypes and
                   restype both set.  An untyped or short binding passes
                   every CPU test (the CPU path never calls the kernel) and
                   corrupts a launch on the card;
  timeline-event   the `timeline-event N (name)` markers of
                   cpp/stat/timeline.h and rpc/observe.py are unique,
                   consecutive from 1 and identical;
  digest-wire      the `digest-wire N (MAGIC)` markers of cpp/stat/digest.h
                   and rpc/observe.py likewise;
  flag-exists      every literal `trpc_*` flag the port, chip_smoke.py or
                   tests/test_torch_*.py sets or reads is defined in cpp/;
  error-code-sync  the `constexpr int kE* = N;` constants of cpp/ match
                   rpc/_lib.py's ERROR_CODES both ways, and no two share a
                   code.
"""

from __future__ import annotations

import ast
import collections
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
RUNTIME_DIRS = ["base", "fiber", "stat", "net", "capi"]


class Tree:
    """The checkout under lint and the violations found in it."""

    def __init__(self, root: pathlib.Path):
        self.root = root
        self.cpp = root / "cpp"
        self.port = root / "brpc_tpu_torch"
        self.violations: list[str] = []
        self._asts: dict = {}

    def flag(self, path: pathlib.Path, line: int, rule: str,
             msg: str) -> None:
        self.violations.append(
            f"{path.relative_to(self.root)}:{line}: [{rule}] {msg}")

    def ast_of(self, path: pathlib.Path) -> ast.Module:
        if path not in self._asts:
            self._asts[path] = ast.parse(path.read_text(), str(path))
        return self._asts[path]

    def runtime_files(self, exts=(".cc", ".h")) -> list:
        out = []
        for d in RUNTIME_DIRS:
            for p in sorted((self.cpp / d).iterdir()):
                if p.suffix in exts:
                    out.append(p)
        return out

    def port_sources(self) -> list:
        """The port's Python files and chip_smoke.py."""
        return (sorted(self.port.rglob("*.py"))
                + [self.root / "chip_smoke.py"])


# ---- flag-validator ------------------------------------------------------

_DEFINE = re.compile(r"define_(?:bool|int64|double|string)\(")


def check_flag_validators(t: Tree) -> None:
    for path in t.runtime_files():
        lines = path.read_text().splitlines()
        for i, text in enumerate(lines):
            if not _DEFINE.search(text):
                continue
            if ("Flag* Flag::define_" in text
                    or "static Flag* define_" in text):
                continue  # the registry's own declaration/definition
            # The first argument: the rest of this line and the next (the
            # runtime wraps a define at most once before the name).
            head = text + " " + (lines[i + 1] if i + 1 < len(lines) else "")
            m = re.search(r"define_(?:bool|int64|double|string)\(\s*([^,)]+)",
                          head)
            first = m.group(1).strip() if m else ""
            if first.startswith('"') and not first.startswith('"trpc_'):
                continue  # not a trpc_* flag
            if not first or first.startswith("//"):
                continue
            # The window ends at the next define: a neighbour's validator
            # is not this flag's.
            window_lines = [text]
            for nxt in lines[i + 1:i + 30]:
                if _DEFINE.search(nxt):
                    break
                window_lines.append(nxt)
            window = "\n".join(window_lines)
            if ("set_validator" not in window
                    and "set_int_range" not in window
                    and "set_reloadable(false)" not in window):
                t.flag(path, i + 1, "flag-validator",
                       f"define of {first or '<flag>'} has no set_validator/"
                       "set_int_range (or set_reloadable(false)) within 30 "
                       "lines")


# ---- var-help ------------------------------------------------------------

def _balanced_end(text: str, start: int, pair: str = "()") -> int:
    """The index of the bracket that closes the one at `start`."""
    depth, j = 0, start
    while j < len(text):
        if text[j] == pair[0]:
            depth += 1
        elif text[j] == pair[1]:
            depth -= 1
            if depth == 0:
                break
        j += 1
    return j


def _split_top(args: str) -> list:
    """`args` split at the commas outside brackets and strings."""
    parts, d, in_str, last, k = [], 0, False, 0, 0
    while k < len(args):
        c = args[k]
        if in_str:
            if c == "\\":
                k += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c in "([{":
            d += 1
        elif c in ")]}":
            d -= 1
        elif c == "," and d == 0:
            parts.append(args[last:k])
            last = k + 1
        k += 1
    parts.append(args[last:])
    return parts


def _expose_calls(text: str) -> list:
    """Every `.expose(` / `->expose(` call site of `text` as (line,
    first_arg, rest_args), split at the first top-level comma (rest_args
    is "" for a single argument)."""
    out = []
    for m in re.finditer(r"[\w\])](?:\.|->)expose\(", text):
        start = text.index("(", m.start() + 1)
        args = text[start + 1:_balanced_end(text, start)]
        first, *rest = _split_top(args)
        line = text[:m.start()].count("\n") + 1
        out.append((line, first, ",".join(rest)))
    return out


def check_var_help(t: Tree) -> None:
    for path in t.runtime_files():
        text = path.read_text()
        lines = text.splitlines()
        for line, _first, rest in _expose_calls(text):
            if not rest:
                t.flag(path, line, "var-help",
                       "expose() without a HELP description: "
                       + lines[line - 1].strip())


# ---- capi-gil ------------------------------------------------------------

Proto = collections.namedtuple("Proto", "path line ret params")


def _extern_c_spans(text: str) -> list:
    return [(m.end(), _balanced_end(text, m.end() - 1, "{}"))
            for m in re.finditer(r'extern\s+"C"\s*\{', text)]


def _params(text: str, open_at: int) -> list:
    """The parameters of the prototype whose `(` is at `open_at`, counted
    by balancing parentheses: a function-pointer parameter is one, and
    `()` or `(void)` is none."""
    inner = text[open_at + 1:_balanced_end(text, open_at)]
    inner = re.sub(r"//[^\n]*|/\*.*?\*/", " ", inner, flags=re.S)
    params = [" ".join(p.split()) for p in _split_top(inner)]
    return [] if params in ([""], ["void"]) else params


def c_prototypes(path: pathlib.Path, name: str = r"trpc_[a-z0-9_]+") -> dict:
    """{function: Proto} of the `extern "C"` functions of one C/C++/CUDA
    source whose names match `name`: inside `extern "C" { ... }` blocks
    (return type at the start of a line) and in `extern "C" <ret> f(`."""
    text = path.read_text()
    head = r"([A-Za-z_][A-Za-z0-9_ ]*?[\s*]+)(" + name + r")\s*\("
    in_block = re.compile("^" + head, re.M)
    found = list(re.finditer(r'extern\s+"C"\s+' + head, text))
    for lo, hi in _extern_c_spans(text):
        found.extend(in_block.finditer(text, lo, hi))
    out = {}
    for m in found:
        line = text[:m.start(2)].count("\n") + 1
        out.setdefault(m.group(2), Proto(path, line, " ".join(
            m.group(1).split()), _params(text, m.end() - 1)))
    return out


def _fn_pointer_types(text: str) -> set:
    """Names that `using X = R (*)(...)` or `typedef R (*X)(...)` make
    function-pointer types."""
    return (set(re.findall(r"\busing\s+(\w+)\s*=[^;]*\(\s*\*\s*\)", text))
            | set(re.findall(r"\btypedef[^;]*\(\s*\*\s*(\w+)\s*\)", text)))


_C_WIDE = re.compile(
    r"\b(?:size_t|ssize_t|u?int64_t|u?intptr_t|ptrdiff_t|long)\b")


def c_kind(decl: str, fn_pointers=frozenset()) -> str:
    """The slot a C return or parameter declaration takes: ptr, int64,
    int (32 bits or narrower), double, float or void."""
    if ("*" in decl or "(" in decl or "[" in decl
            or fn_pointers & set(re.findall(r"\w+", decl))):
        return "ptr"
    if _C_WIDE.search(decl):
        return "int64"
    for word in ("double", "float"):
        if re.search(rf"\b{word}\b", decl):
            return word
    return "void" if decl == "void" else "int"


_CTYPES_KIND = {
    **dict.fromkeys(("c_void_p", "c_char_p", "c_wchar_p"), "ptr"),
    **dict.fromkeys(("c_size_t", "c_ssize_t", "c_int64", "c_uint64",
                     "c_longlong", "c_ulonglong", "c_long", "c_ulong"),
                    "int64"),
    **dict.fromkeys(("c_int", "c_uint", "c_int32", "c_uint32", "c_int16",
                     "c_uint16", "c_int8", "c_uint8", "c_short", "c_ushort",
                     "c_byte", "c_ubyte", "c_char", "c_bool"), "int"),
    "c_double": "double", "c_float": "float",
}


def _aliases(tree: ast.Module) -> dict:
    """{name: value} of a module's top-level `name = <expr>` lines."""
    return {n.targets[0].id: n.value for n in tree.body
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)}


def ctypes_kind(node: ast.AST, aliases: dict) -> str:
    """The slot a ctypes type expression fills, resolving the module's own
    aliases (`_P = ctypes.c_void_p`); "?" when it cannot tell."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Call):
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", "")
        return "ptr" if fname == "POINTER" else "?"
    if isinstance(node, ast.Attribute):
        return _CTYPES_KIND.get(node.attr, "?")
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return ctypes_kind(aliases[node.id], aliases)
        return _CTYPES_KIND.get(node.id, "?")
    return "?"


def _check_binding(t: Tree, path: pathlib.Path, line: int, name: str,
                   proto: Proto, argtypes, restype, aliases: dict,
                   fn_pointers: set) -> None:
    """One binding's argtypes (a list of nodes) and restype (a node)
    against its C prototype."""
    where = f"{proto.path.relative_to(t.root)}:{proto.line}"
    if len(argtypes) != len(proto.params):
        t.flag(path, line, "capi-gil",
               f"{name} takes {len(proto.params)} argument(s) ({where}) but "
               f"argtypes lists {len(argtypes)}")
    for i, (decl, node) in enumerate(zip(proto.params, argtypes)):
        want, got = c_kind(decl, fn_pointers), ctypes_kind(node, aliases)
        if want != got:
            t.flag(path, line, "capi-gil",
                   f"{name} argument {i} is `{decl}` ({want}, {where}) but "
                   f"argtypes gives {ast.unparse(node)} ({got})")
    want, got = c_kind(proto.ret, fn_pointers), ctypes_kind(restype, aliases)
    if want != got:
        t.flag(path, line, "capi-gil",
               f"{name} returns `{proto.ret}` ({want}, {where}) but restype "
               f"is {ast.unparse(restype)} ({got})")


def _check_cdll(t: Tree) -> None:
    for rel in ("rpc/_lib.py", "ops/_kernels.py"):
        path = t.port / rel
        if "ctypes.CDLL(" not in path.read_text():
            t.flag(path, 1, "capi-gil",
                   f"{rel} must load its library through ctypes.CDLL")
    for path in t.port_sources():
        if not re.search("pydll", path.read_text(), re.I):
            continue
        for node in ast.walk(t.ast_of(path)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.ImportFrom)
                     else [getattr(node, "attr", getattr(node, "id", ""))])
            if "PyDLL" in names or "pydll" in names:
                t.flag(path, node.lineno, "capi-gil",
                       "PyDLL holds the GIL across native calls; bind "
                       "through ctypes.CDLL")


def _check_signature_table(t: Tree) -> None:
    lib_py = t.port / "rpc" / "_lib.py"
    aliases = _aliases(t.ast_of(lib_py))
    table = aliases.get("_SIGNATURES")
    if not isinstance(table, ast.Dict):
        t.flag(lib_py, 1, "capi-gil",
               "_lib.py must type the native entries in a `_SIGNATURES` "
               "dict literal")
        return
    protos, fn_pointers = {}, set()
    for path in sorted((t.cpp / "capi").glob("*.cc")):
        for name, proto in c_prototypes(path).items():
            protos.setdefault(name, proto)
        fn_pointers |= _fn_pointer_types(path.read_text())
    typed = set()
    for key, value in zip(table.keys, table.values):
        name = key.value if isinstance(key, ast.Constant) else None
        if (not isinstance(name, str) or not isinstance(value, ast.Tuple)
                or len(value.elts) != 2
                or not isinstance(value.elts[0], ast.List)):
            t.flag(lib_py, value.lineno, "capi-gil",
                   "a _SIGNATURES entry must read `\"trpc_x\": "
                   "([argtypes...], restype)`")
            continue
        typed.add(name)
        proto = protos.get(name)
        if proto is None:
            t.flag(lib_py, key.lineno, "capi-gil",
                   f"_SIGNATURES types {name}, which no extern \"C\" "
                   "function of cpp/capi/*.cc defines")
            continue
        _check_binding(t, lib_py, key.lineno, name, proto,
                       value.elts[0].elts, value.elts[1], aliases,
                       fn_pointers)
    for path in t.port_sources():
        if ".trpc_" not in path.read_text():
            continue
        for node in ast.walk(t.ast_of(path)):
            if (isinstance(node, ast.Attribute)
                    and re.fullmatch(r"trpc_[a-z0-9_]+", node.attr)
                    and node.attr not in typed):
                t.flag(path, node.lineno, "capi-gil",
                       f"{node.attr} is used on the native library but "
                       "has no _SIGNATURES entry (it would run untyped, "
                       "with a 32-bit int return)")


def _kernel_load(node: ast.AST, consts: dict):
    """The csrc kernel name of a `_kernels.load(K)` call, else None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "load"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "_kernels" and len(node.args) == 1):
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Name):
        arg = consts.get(arg.id)
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return "?"


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(scope: ast.AST):
    """The nodes of `scope` in source order, without those of the
    functions and classes it defines."""
    for child in ast.iter_child_nodes(scope):
        yield child
        if not isinstance(child, (*_SCOPES, ast.ClassDef)):
            yield from _own_nodes(child)


def _kernel_bindings(tree: ast.Module) -> tuple:
    """({(kernel, symbol): [line, argtypes node, restype node]}, aliases)
    for the symbols one port module takes from `_kernels.load(...)`: as
    `fn = _kernels.load(K).sym` or `lib = _kernels.load(K)` then
    `lib.sym`, with `.argtypes` / `.restype` set on either, within one
    function (or the module body)."""
    aliases = _aliases(tree)
    found: dict = {}
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, _SCOPES)]
    for scope in scopes:
        libs, syms = {}, {}

        def symbol(node):
            if isinstance(node, ast.Name):
                return syms.get(node.id)
            if isinstance(node, ast.Attribute):
                v = node.value
                kernel = (libs.get(v.id) if isinstance(v, ast.Name)
                          else _kernel_load(v, aliases))
                if kernel is not None:
                    return kernel, node.attr
            return None

        for node in _own_nodes(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
                if isinstance(target, ast.Name):
                    kernel = _kernel_load(value, aliases)
                    if kernel is not None:
                        libs[target.id] = kernel
                    elif symbol(value) is not None:
                        syms[target.id] = symbol(value)
                elif (isinstance(target, ast.Attribute)
                      and target.attr in ("argtypes", "restype")
                      and symbol(target.value) is not None):
                    entry = found.setdefault(symbol(target.value),
                                             [node.lineno, None, None])
                    entry[1 if target.attr == "argtypes" else 2] = value
                    continue
            key = symbol(node) if isinstance(node, ast.Attribute) else None
            if key is not None and node.attr not in ("argtypes", "restype"):
                found.setdefault(key, [node.lineno, None, None])
    return found, aliases


def _check_kernel_bindings(t: Tree) -> None:
    csrc = t.port / "csrc"
    protos = {p.stem: c_prototypes(p, r"\w+")
              for p in sorted(csrc.glob("*.cu"))}
    for path in sorted(t.port.rglob("*.py")):
        if "_kernels.load(" not in path.read_text():
            continue
        found, aliases = _kernel_bindings(t.ast_of(path))
        for (kernel, sym), (line, argtypes, restype) in sorted(found.items()):
            proto = protos.get(kernel, {}).get(sym)
            if proto is None:
                t.flag(path, line, "capi-gil",
                       f"{sym} is loaded from csrc/{kernel}.cu, which "
                       "defines no such extern \"C\" function")
                continue
            if argtypes is None or restype is None:
                t.flag(path, line, "capi-gil",
                       f"{sym} is loaded without "
                       + " and ".join(n for n, v in (("argtypes", argtypes),
                                                     ("restype", restype))
                                      if v is None))
                continue
            if not isinstance(argtypes, ast.List):
                t.flag(path, line, "capi-gil",
                       f"{sym}.argtypes must be a list literal")
                continue
            _check_binding(t, path, line, sym, proto, argtypes.elts, restype,
                           aliases, set())


def check_capi_bindings(t: Tree) -> None:
    _check_cdll(t)
    _check_signature_table(t)
    _check_kernel_bindings(t)


# ---- tail-group ----------------------------------------------------------

def check_tail_groups(t: Tree) -> None:
    path = t.cpp / "net" / "protocol.cc"
    text = path.read_text()

    def groups_in(fn: str) -> list:
        m = re.search(rf"\n\S[^\n]*\b{fn}\(", text)
        if m is None:
            t.flag(path, 1, "tail-group", f"cannot locate {fn}()")
            return []
        # The function runs to the next top-level definition.
        nxt = re.search(r"\n[A-Za-z_][^\n]*\([^\n]*\)\s*\{", text[m.end():])
        body = text[m.start():m.end() + (nxt.start() if nxt else len(text))]
        return [(int(g.group(1)), g.group(2)) for g in re.finditer(
            r"//\s*tail-group\s+(\d+)\s*\(([a-z0-9_]+)\)", body)]

    enc = groups_in("encode_meta")
    dec = groups_in("decode_meta")
    for fn, seq in (("encode_meta", enc), ("decode_meta", dec)):
        ids = [n for n, _ in seq]
        if len(ids) != len(set(ids)):
            t.flag(path, 1, "tail-group",
                   f"{fn} has duplicate tail-group ids: {ids}")
        if ids != sorted(ids) or (ids and ids != list(range(1, len(ids) + 1))):
            t.flag(path, 1, "tail-group",
                   f"{fn} tail-group ids not consecutive from 1: {ids}")
    if enc and dec and enc != dec:
        t.flag(path, 1, "tail-group",
               f"encode/decode tail groups diverge: {enc} vs {dec} — "
               "a one-sided group is a wire break")


# ---- timeline-event and digest-wire --------------------------------------

def _markers(path: pathlib.Path, comment: str, marker: str) -> list:
    return [(int(m.group(1)), m.group(2)) for m in
            re.finditer(comment + r"\s*" + marker, path.read_text())]


def check_timeline_events(t: Tree) -> None:
    cpp_path = t.cpp / "stat" / "timeline.h"
    py_path = t.port / "rpc" / "observe.py"
    marker = r"timeline-event\s+(\d+)\s*\(([a-z0-9_]+)\)"
    enc = _markers(cpp_path, r"//", marker)
    dec = _markers(py_path, r"#", marker)
    for path, side, seq in ((cpp_path, "encoder", enc),
                            (py_path, "decoder", dec)):
        if not seq:
            t.flag(path, 1, "timeline-event",
                   f"no timeline-event markers found on the {side} side")
            continue
        ids = [n for n, _ in seq]
        if len(ids) != len(set(ids)):
            t.flag(path, 1, "timeline-event",
                   f"{side} has duplicate timeline-event ids: {ids}")
        if ids != list(range(1, len(ids) + 1)):
            t.flag(path, 1, "timeline-event",
                   f"{side} timeline-event ids not consecutive from 1 "
                   f"(append-only table): {ids}")
    if enc and dec and enc != dec:
        t.flag(py_path, 1, "timeline-event",
               f"encoder/decoder timeline tables diverge: {enc} vs {dec} "
               "— a one-sided event type breaks every recorded binary dump")


def check_digest_wire(t: Tree) -> None:
    cpp_path = t.cpp / "stat" / "digest.h"
    py_path = t.port / "rpc" / "observe.py"
    marker = r"digest-wire\s+(\d+)\s*\(([A-Z0-9_]+)\)"
    # digest.h owns the canonical table of both layouts (slo.cc restates
    # the TRPCFL01 marker at its encode site); observe.py marks its
    # struct tables.
    enc = _markers(cpp_path, r"//", marker)
    dec = _markers(py_path, r"#", marker)
    for path, side, seq in ((cpp_path, "encoder", enc),
                            (py_path, "decoder", dec)):
        if not seq:
            t.flag(path, 1, "digest-wire",
                   f"no digest-wire markers found on the {side} side")
            continue
        ids = sorted(n for n, _ in seq)
        if ids != list(range(1, len(ids) + 1)):
            t.flag(path, 1, "digest-wire",
                   f"{side} digest-wire ids not unique/consecutive from 1 "
                   f"(append-only table): {ids}")
    if enc and dec and sorted(enc) != sorted(dec):
        t.flag(py_path, 1, "digest-wire",
               f"encoder/decoder digest-wire tables diverge: {sorted(enc)} "
               f"vs {sorted(dec)} — a one-sided layout change corrupts "
               "every fleet merge")


# ---- flag-exists ---------------------------------------------------------

# A flag defined with a literal name, directly (Flag::define_*) or through
# a defining wrapper (rma.cc int_flag, per-file *_flag helpers).
_FLAG_DEF = re.compile(r'(?:define_(?:bool|int64|double|string)|[a-z_]*flag)'
                       r'\(\s*"(trpc_[a-z0-9_]+)"')


def check_flag_references(t: Tree) -> None:
    defined = set()
    for path in t.runtime_files():
        defined.update(_FLAG_DEF.findall(path.read_text()))
    dynamic_prefixes = ("max_concurrency_",)  # per-method bounds
    ref = re.compile(r'(?:set_flag|get_flag|trpc_flag_set|trpc_flag_get)'
                     r'\(\s*[bf]?"(trpc_[a-z0-9_]+)"')
    files = (t.port_sources()
             + sorted((t.root / "tests").glob("test_torch_*.py")))
    for path in files:
        text = path.read_text()
        for m in ref.finditer(text):
            name = m.group(1)
            if name in defined or name.startswith(dynamic_prefixes):
                continue
            t.flag(path, text[:m.start()].count("\n") + 1, "flag-exists",
                   f"flag '{name}' is referenced here but no "
                   "Flag::define_* in cpp/ defines it")


# ---- tuner-rule ----------------------------------------------------------

def _defined_flag_windows(t: Tree) -> dict:
    """{flag: the 30 lines from its define} for every trpc_* flag cpp/
    defines with a literal name: set_reloadable(false) there makes it
    immutable."""
    out = {}
    for path in t.runtime_files():
        text = path.read_text()
        for m in _FLAG_DEF.finditer(text):
            out[m.group(1)] = "\n".join(
                text[m.start():].split("\n", 30)[:30])
    return out


def check_tuner_rules(t: Tree) -> None:
    path = t.cpp / "stat" / "tuner.cc"
    lines = path.read_text().splitlines()
    windows = _defined_flag_windows(t)

    # A knob assignment carries a marker naming the same literal.
    marker = re.compile(r"//\s*tuner-knob\s*\((trpc_[a-z0-9_]+)\)")
    assign = re.compile(r'\.knob\s*=\s*"(trpc_[a-z0-9_]+)"')
    knobs = []
    for i, ln in enumerate(lines):
        am, mm = assign.search(ln), marker.search(ln)
        if am is None and mm is None:
            continue
        if am is None or mm is None or am.group(1) != mm.group(1):
            t.flag(path, i + 1, "tuner-rule",
                   "rule-table knob assignment and its tuner-knob marker "
                   f"must name the same flag: {ln.strip()}")
            continue
        knobs.append((i + 1, am.group(1)))
    if not knobs:
        t.flag(path, 1, "tuner-rule",
               "no tuner-knob markers found in the built-in rule table")
    for line, knob in knobs:
        window = windows.get(knob)
        if window is None:
            t.flag(path, line, "tuner-rule",
                   f"tuner knob '{knob}' is not defined by any "
                   "Flag::define_* in cpp/ — the rule can never actuate")
        elif "set_reloadable(false)" in window:
            t.flag(path, line, "tuner-rule",
                   f"tuner knob '{knob}' is defined immutable — the "
                   "validated reload path would refuse every actuation")

    # Input vars are exposed somewhere in cpp/ with a non-empty HELP.
    inpat = re.compile(r'"([a-z0-9_]+)",\s*//\s*tuner-input')
    inputs = [(i + 1, m.group(1)) for i, ln in enumerate(lines)
              for m in [inpat.search(ln)] if m is not None]
    if not inputs:
        t.flag(path, 1, "tuner-rule", "no tuner-input markers found")
    exposes = [(first.strip(), rest) for p in t.runtime_files()
               for _line, first, rest in _expose_calls(p.read_text())]
    for line, name in inputs:
        # A name ending in '_' is a dynamic family: its prefix matches with
        # the quote left open, so `"prefix" + suffix` and `"prefix0"` count.
        hit = any(
            (lead.startswith(f'"{name}"')
             or (name.endswith("_") and lead.startswith(f'"{name}')))
            and re.search(r'"[^"]', rest)
            for lead, rest in exposes)
        if not hit:
            t.flag(path, line, "tuner-rule",
                   f"tuner input var '{name}' is not exposed with a "
                   "Prometheus HELP description anywhere in cpp/")


# ---- error-code-sync -----------------------------------------------------

def check_error_codes(t: Tree) -> None:
    defpat = re.compile(r"constexpr\s+int\s+(kE[A-Za-z0-9]+)\s*=\s*(\d+)\s*;")
    cpp_codes: dict = {}
    by_value: dict = {}
    for path in t.runtime_files(exts=(".h",)):
        text = path.read_text()
        for m in defpat.finditer(text):
            name, code = m.group(1), int(m.group(2))
            line = text[:m.start()].count("\n") + 1
            if name in cpp_codes and cpp_codes[name][0] != code:
                t.flag(path, line, "error-code-sync",
                       f"{name} redefined with a different value "
                       f"({cpp_codes[name][0]} vs {code})")
            cpp_codes[name] = (code, path, line)
            other = by_value.get(code)
            if other is not None and other != name:
                t.flag(path, line, "error-code-sync",
                       f"{name} and {other} share code {code} — clients "
                       "cannot type the exception")
            by_value[code] = name
    lib_py = t.port / "rpc" / "_lib.py"
    text = lib_py.read_text()
    block = re.search(r"ERROR_CODES\s*=\s*\{(.*?)\}", text, re.S)
    if block is None:
        t.flag(lib_py, 1, "error-code-sync",
               "_lib.py must define the ERROR_CODES mirror of the cpp "
               "kE* table")
        return
    py_codes = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'"(kE[A-Za-z0-9]+)":\s*(\d+)', block.group(1))}
    py_line = text[:block.start()].count("\n") + 1
    for name, (code, path, line) in sorted(cpp_codes.items()):
        if name not in py_codes:
            t.flag(lib_py, py_line, "error-code-sync",
                   f"{name} ({code}, {path.relative_to(t.root)}:{line}) has "
                   "no entry in ERROR_CODES")
        elif py_codes[name] != code:
            t.flag(lib_py, py_line, "error-code-sync",
                   f"ERROR_CODES[{name!r}] = {py_codes[name]} but cpp "
                   f"defines {code}")
    for name in sorted(py_codes):
        if name not in cpp_codes:
            t.flag(lib_py, py_line, "error-code-sync",
                   f"ERROR_CODES entry {name!r} matches no constexpr kE* "
                   "in cpp/")


# ---- atomic-comment ------------------------------------------------------

ATOMIC_FILES = [
    "net/socket.cc", "net/socket.h", "net/messenger.cc", "net/messenger.h",
    "net/qos.cc", "net/qos.h", "net/stripe.cc", "net/stripe.h",
    "net/rma.cc", "net/rma.h", "net/kvstore.cc", "net/kvstore.h",
    "net/lb_hint.h",
]
ATOMIC_RE = re.compile(r"memory_order_(relaxed|acquire)\b")
# "//" inside a string literal ("http://...") is not a comment.
STRING_LIT_RE = re.compile(r'"(?:[^"\\]|\\.)*"')


def check_atomic_comments(t: Tree) -> None:
    for rel in ATOMIC_FILES:
        path = t.cpp / rel
        lines = path.read_text().splitlines()
        for i, text in enumerate(lines):
            if not ATOMIC_RE.search(text):
                continue
            window = [text] + lines[max(0, i - 4):i]
            if any("//" in STRING_LIT_RE.sub('""', w) for w in window):
                continue
            t.flag(path, i + 1, "atomic-comment",
                   "relaxed/acquire atomic without a justification comment "
                   "(same line or the 4 lines above): " + text.strip())


CHECKS = (check_flag_validators, check_var_help, check_capi_bindings,
          check_tail_groups, check_timeline_events, check_digest_wire,
          check_flag_references, check_tuner_rules, check_error_codes,
          check_atomic_comments)


def lint(root=None) -> list:
    """The violations of every rule in the checkout at `root` (default:
    this one), in the reference's order and format."""
    t = Tree(pathlib.Path(root or REPO).resolve())
    for check in CHECKS:
        check(t)
    return t.violations


def main(root=None) -> int:
    violations = lint(root)
    if violations:
        print(f"lint_trpc: {len(violations)} violation(s)")
        for v in violations:
            print("  " + v)
        return 1
    print("lint_trpc: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
