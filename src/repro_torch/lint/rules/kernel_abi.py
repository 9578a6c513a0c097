"""kernel-abi: the hand-written kernels' ctypes seam, held against their
CUDA sources (the port's counterpart of
``repro/lint/rules/pallas_tiling.py``: both guard what the CPU test
suites cannot see, because the kernels never run there).

Project scope. It reads ``kernels/_build.py`` (``SIGNATURES``: each C
entry's ``argtypes`` and ``restype``, declared by hand), ``kernels/ops.py``
(the ``_launch(name, "<entry>", ...)`` calls, to which ``_launch`` appends
the stream) and ``kernels/csrc/*.cu``, and checks:

1. every ``SIGNATURES`` row has one ``extern "C"`` definition with the
   same argument count and kinds (pointer → ``c_void_p``, ``int`` →
   ``c_int``, ``long long``/``int64_t`` → ``c_longlong``) and an ``int``
   return, and every ``extern "C"`` entry has a row — a dropped or
   mistyped argtype silently truncates a pointer or an int64;
2. every ``_launch`` with a literal entry passes ``len(argtypes) - 1``
   arguments;
3. every ``<<<grid, block, smem, stream>>>`` and ``cudaLaunchKernelEx``
   launch names the entry's stream (a parameter of the launching
   function), never the legacy default stream;
4. a ``__global__`` with ``__launch_bounds__(T, ...)`` is launched with a
   block size equal to T;
5. dynamic shared memory above 48 KB comes with a
   ``cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
   ...)`` for that kernel (or a helper that sets it) in the launching
   function;
6. the launch's error is read (``cudaGetLastError()`` after a ``<<<>>>``
   launch, ``cudaLaunchKernelEx``'s result used), and no function that
   reaches a launch returns a literal success.

A check whose value the scanner cannot resolve (a template parameter, a
computed block size or shared-memory size) reports nothing. Text
scanning only: comments are blanked first, and a ``// lint:
allow[kernel-abi] reason`` comment suppresses a finding in a source.
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

from ..astutil import Module
from ..core import ProjectContext, register

_CTYPES_KIND = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_int": "int",
    "c_int32": "int", "c_uint": "unsigned", "c_uint32": "unsigned",
    "c_longlong": "long long", "c_int64": "long long",
    "c_ulonglong": "unsigned long long", "c_uint64": "unsigned long long",
    "c_size_t": "unsigned long long", "c_float": "float",
    "c_double": "double", "c_bool": "bool"}
_NO_STREAM = ("0", "NULL", "nullptr", "cudaStreamLegacy", "0ull")
_BIG_SMEM = 48 * 1024
_KEYWORDS = ("if", "for", "while", "switch", "return", "sizeof", "catch")


# -- C sources ---------------------------------------------------------------

def _blank_comments(text: str) -> str:
    """``text`` with every comment's characters (not its newlines)
    replaced by spaces, so offsets and line numbers survive."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [c if c == "\n" else " " for c in text[i:j]]
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket closing the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _split_top(text: str) -> List[str]:
    """``text`` split at the commas outside (), [] and {} (template
    arguments with commas are not split apart: none is launched here)."""
    parts, depth, cur = [], 0, []
    for c in text:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        parts.append("".join(cur).strip())
    return parts


def _c_kind(decl: str) -> str:
    """The ctypes-relevant kind of a C parameter declaration."""
    if "*" in decl:
        return "pointer"
    words = re.findall(r"[A-Za-z_]\w*", decl)[:-1]
    words = [w for w in words if w not in ("const", "volatile",
                                           "__restrict__", "signed")]
    t = " ".join(words)
    return {"int": "int", "int32_t": "int", "unsigned": "unsigned",
            "unsigned int": "unsigned", "uint32_t": "unsigned",
            "long long": "long long", "long long int": "long long",
            "int64_t": "long long", "long": "long long",
            "unsigned long long": "unsigned long long",
            "uint64_t": "unsigned long long",
            "size_t": "unsigned long long"}.get(t, t)


@dataclasses.dataclass
class CFunction:
    name: str
    header: str                     # everything before the parameter list
    params: List[Tuple[str, int]]   # (declaration, line)
    body: str                       # text between the braces
    body_start: int                 # offset of the body in the source
    line: int                       # line of the name
    extern_c: bool


class CSource:
    """One ``.cu`` file: its top-level functions (inside anonymous or named
    namespaces too) and its ``constexpr`` integer constants."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.clean = _blank_comments(text)
        self.functions: List[CFunction] = []
        self._scan(0, len(self.clean))
        self.consts: Dict[str, str] = {}
        for m in re.finditer(
                r"^(?:static\s+)?constexpr\s+"
                r"(?:unsigned\s+|size_t\s+|long\s+)*"
                r"(?:int|size_t|long|unsigned)?\s*(\w+)\s*=\s*([^;]+);",
                self.clean, re.M):
            self.consts[m.group(1)] = m.group(2).strip()

    def line_of(self, offset: int) -> int:
        return self.text.count("\n", 0, offset) + 1

    def _scan(self, start: int, end: int) -> None:
        text = self.clean
        i = boundary = start
        while i < end:
            c = text[i]
            if c in ";}":
                boundary = i + 1
            elif c == "{":
                header = text[boundary:i]
                close = _match(text, i, "{", "}")
                if re.search(r"\bnamespace\b", header):
                    self._scan(i + 1, close)
                else:
                    self._maybe_function(header, boundary, i, close)
                i = boundary = close + 1
                continue
            i += 1

    def _maybe_function(self, header: str, h_start: int, brace: int,
                        close: int) -> None:
        head = re.sub(r"\b(const|noexcept|override)\s*$", "",
                      header.rstrip()).rstrip()
        if not head.endswith(")") or "=" in head.split("(")[0]:
            return
        p_close = h_start + len(head) - 1
        depth, p_open = 0, p_close
        for j in range(p_close, h_start - 1, -1):
            if self.clean[j] == ")":
                depth += 1
            elif self.clean[j] == "(":
                depth -= 1
                if depth == 0:
                    p_open = j
                    break
        m = re.search(r"(\w+)\s*$", self.clean[h_start:p_open])
        if m is None or m.group(1) in _KEYWORDS:
            return
        params = []
        off = p_open + 1
        for part in self.clean[p_open + 1:p_close].split(","):
            decl = part.strip()
            if decl and decl != "void":
                lead = len(part) - len(part.lstrip())
                params.append((decl, self.line_of(off + lead)))
            off += len(part) + 1
        name_off = h_start + m.start(1)
        self.functions.append(CFunction(
            name=m.group(1), header=self.clean[h_start:name_off],
            params=params, body=self.clean[brace + 1:close],
            body_start=brace + 1, line=self.line_of(name_off),
            extern_c='extern "C"' in self.clean[h_start:name_off]))

    def function(self, name: str) -> Optional[CFunction]:
        for fn in self.functions:
            if fn.name == name:
                return fn
        return None

    def evaluate(self, expr: str, depth: int = 0) -> Optional[int]:
        """The integer value of a constant C expression over this file's
        ``constexpr`` ints; ``dim3(x, y, z)`` is x·y·z. None when any name
        is not such a constant."""
        expr = expr.strip()
        m = re.fullmatch(r"dim3\s*\((.*)\)", expr, re.S)
        if m:
            prod = 1
            for part in _split_top(m.group(1)):
                v = self.evaluate(part, depth)
                if v is None:
                    return None
                prod *= v
            return prod
        expr = re.sub(r"\(\s*(?:int|unsigned|size_t|long long)\s*\)", "",
                      expr)
        expr = re.sub(r"(\d+)(?:ull|ll|u|l)\b", r"\1", expr, flags=re.I)

        def sub(mm):
            name = mm.group(0)
            if name not in self.consts or depth > 8:
                raise KeyError(name)
            v = self.evaluate(self.consts[name], depth + 1)
            if v is None:
                raise KeyError(name)
            return str(v)
        try:
            expr = re.sub(r"[A-Za-z_]\w*", sub, expr)
        except KeyError:
            return None
        if not re.fullmatch(r"[\d\s+\-*/%()<>]*", expr):
            return None
        try:
            value = eval(expr.replace("/", "//"), {"__builtins__": {}})
        except (SyntaxError, ZeroDivisionError, TypeError):
            return None
        return value if isinstance(value, int) else None


@dataclasses.dataclass
class Launch:
    kernel: str                     # the kernel's name, template args cut
    block: Optional[str]
    smem: Optional[str]
    stream: Optional[str]
    offset: int                     # of the launch in the source
    end: int                        # of its statement's ';'
    kind: str                       # "chevron" | "ex"


def _kernel_name(expr: str, fn: CFunction) -> str:
    expr = re.sub(r"<.*>", "", expr.strip()).strip()
    alias = re.search(rf"\bauto\s+{re.escape(expr)}\s*=\s*(\w+)", fn.body)
    return alias.group(1) if alias else expr


def _callee_before(head: str) -> str:
    """The name (template arguments cut) that ends ``head``: the kernel of
    a ``name<...>\n    <<<...>>>`` launch."""
    head = head.rstrip()
    if head.endswith(">"):
        depth = 0
        for j in range(len(head) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(head[j], 0)
            if depth == 0:
                head = head[:j].rstrip()
                break
    m = re.search(r"(\w+)$", head)
    return m.group(1) if m else ""


def _launches(src: CSource, fn: CFunction) -> List[Launch]:
    out: List[Launch] = []
    body = fn.body
    for m in re.finditer(r"<<<", body):
        cfg_end = body.find(">>>", m.end())
        args = _split_top(body[m.end():cfg_end])
        kernel = _kernel_name(_callee_before(body[:m.start()]), fn)
        out.append(Launch(
            kernel=kernel, block=args[1] if len(args) > 1 else None,
            smem=args[2] if len(args) > 2 else "0",
            stream=args[3] if len(args) > 3 else None,
            offset=fn.body_start + m.start(),
            end=fn.body_start + body.find(";", cfg_end), kind="chevron"))
    for m in re.finditer(r"\bcudaLaunchKernelEx\s*\(", body):
        close = _match(body, m.end() - 1, "(", ")")
        args = _split_top(body[m.end():close])
        if len(args) < 2:
            continue
        cfg = args[0].lstrip("&").strip()

        def field(name):
            f = re.search(rf"\b{re.escape(cfg)}\.{name}\s*=\s*([^;]+);", body)
            return f.group(1).strip() if f else None
        out.append(Launch(
            kernel=_kernel_name(args[1], fn), block=field("blockDim"),
            smem=field("dynamicSmemBytes") or "0", stream=field("stream"),
            offset=fn.body_start + m.start(),
            end=fn.body_start + close, kind="ex"))
    return out


def _uncast(expr: str) -> str:
    expr = expr.strip()
    while True:
        m = re.fullmatch(r"\(\s*[\w:\s\*]+\)\s*(.+)", expr) or \
            re.fullmatch(r"static_cast<[^>]*>\s*\((.*)\)", expr)
        if not m:
            return expr
        expr = m.group(1).strip()


def _param_names(fn: CFunction) -> List[str]:
    return [re.findall(r"\w+", d)[-1] for d, _ in fn.params]


def _launch_bounds(src: CSource, kernel: str) -> Optional[str]:
    for fn in src.functions:
        if fn.name == kernel and "__global__" in fn.header:
            m = re.search(r"__launch_bounds__\s*\(", fn.header)
            if m:
                close = _match(fn.header, m.end() - 1, "(", ")")
                return _split_top(fn.header[m.end():close])[0]
    return None


def _sets_smem(src: CSource, fn: CFunction, kernel: str) -> bool:
    """``fn`` raises ``kernel``'s dynamic shared-memory limit, itself or
    through a helper of this file that sets it on its first argument."""
    attr = "cudaFuncAttributeMaxDynamicSharedMemorySize"
    for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", fn.body):
        args = _split_top(fn.body[m.end():_match(fn.body, m.end() - 1,
                                                   "(", ")")])
        if len(args) > 1 and args[1] == attr and \
                _kernel_name(args[0], fn) == kernel:
            return True
    for helper in src.functions:
        if helper is fn or attr not in helper.body:
            continue
        for m in re.finditer(rf"\b{helper.name}\s*(?:<[^;]*?>)?\s*\(",
                             fn.body):
            args = _split_top(fn.body[m.end():_match(
                fn.body, m.end() - 1, "(", ")")])
            if args and _kernel_name(args[0], fn) == kernel:
                return True
    return False


def _reaches_launch(src: CSource) -> Dict[str, bool]:
    launching = {fn.name for fn in src.functions
                 if "<<<" in fn.body or "cudaLaunchKernelEx" in fn.body}
    changed = True
    while changed:
        changed = False
        for fn in src.functions:
            if fn.name in launching:
                continue
            if any(re.search(rf"\b{name}\s*[<(]", fn.body)
                   for name in launching):
                launching.add(fn.name)
                changed = True
    return {fn.name: fn.name in launching for fn in src.functions}


# -- the Python side ---------------------------------------------------------

def _ctypes_kinds(mod: Module, node: ast.AST,
                  names: Dict[str, str]) -> Optional[List[str]]:
    """``[_P] * 6 + [_I] * 5 + [_P]`` → its kinds; None if not literal."""
    if isinstance(node, ast.List):
        out = []
        for e in node.elts:
            dotted = mod.dotted(e)
            dotted = names.get(dotted, dotted) if dotted else None
            kind = _CTYPES_KIND.get((dotted or "").rsplit(".", 1)[-1])
            if kind is None:
                return None
            out.append(kind)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = (_ctypes_kinds(mod, node.left, names),
                _ctypes_kinds(mod, node.right, names))
        return a + b if a is not None and b is not None else None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        lst, n = node.left, node.right
        if isinstance(lst, ast.Constant):
            lst, n = n, lst
        kinds = _ctypes_kinds(mod, lst, names)
        if kinds is not None and isinstance(n, ast.Constant) and \
                isinstance(n.value, int):
            return kinds * n.value
    return None


def _signatures(mod: Module) -> Dict[str, Tuple[List[str], str, int]]:
    """entry → (argument kinds, restype kind, line) from ``SIGNATURES``."""
    names: Dict[str, str] = {}
    table = None
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
            dotted = mod.dotted(node.value)
            if dotted is not None:
                names[target] = dotted
            if target == "SIGNATURES" and isinstance(node.value, ast.Dict):
                table = node.value
    out: Dict[str, Tuple[List[str], str, int]] = {}
    for key, value in zip(table.keys if table else [],
                          table.values if table else []):
        if not (isinstance(key, ast.Constant) and isinstance(value, ast.Tuple)
                and len(value.elts) == 2):
            continue
        kinds = _ctypes_kinds(mod, value.elts[0], names)
        rest = _ctypes_kinds(mod, ast.List(elts=[value.elts[1]]), names)
        if kinds is not None and rest is not None:
            out[key.value] = (kinds, rest[0], key.lineno)
    return out


def _module(ctx: ProjectContext, rel: str) -> Optional[Module]:
    mod = ctx.module(rel)
    full = os.path.join(ctx.root, rel)
    if mod is None and os.path.exists(full):
        with open(full, "r", encoding="utf-8") as fh:
            mod = Module(full, rel, fh.read())
    return mod


@register("kernel-abi", severity="error", scope="project", help=(
    "The kernels' ctypes SIGNATURES, ops._launch argument counts and the "
    "extern \"C\" entries of csrc/*.cu must agree; launches name the "
    "entry's stream, match __launch_bounds__, raise the shared-memory "
    "limit past 48 KB and return the launch's error."))
def check_kernel_abi(ctx: ProjectContext) -> None:
    cfg = ctx.config
    build = _module(ctx, cfg.kernel_build)
    if build is None:
        return
    sigs = _signatures(build)
    sources: List[CSource] = []
    for pattern in cfg.kernel_sources:
        for full in sorted(glob.glob(os.path.join(ctx.root, pattern))):
            rel = os.path.relpath(full, ctx.root).replace(os.sep, "/")
            with open(full, "r", encoding="utf-8") as fh:
                sources.append(CSource(rel, fh.read()))

    # 1. SIGNATURES against the extern "C" definitions
    entries: Dict[str, List[Tuple[CSource, CFunction]]] = {}
    for src in sources:
        for fn in src.functions:
            if fn.extern_c:
                entries.setdefault(fn.name, []).append((src, fn))
    for name, (kinds, restype, line) in sorted(sigs.items()):
        defs = entries.get(name, [])
        if len(defs) != 1:
            ctx.report(cfg.kernel_build, line, (
                f"SIGNATURES[{name!r}] has {len(defs)} extern \"C\" "
                "definitions in the kernel sources, not one"))
            continue
        src, fn = defs[0]
        where = f"{src.relpath}:{fn.line}"
        if len(fn.params) != len(kinds):
            ctx.report(cfg.kernel_build, line, (
                f"SIGNATURES[{name!r}] declares {len(kinds)} argtypes but "
                f"{where} takes {len(fn.params)} arguments"))
        else:
            for i, ((decl, pline), kind) in enumerate(zip(fn.params, kinds)):
                ckind = _c_kind(decl)
                if ckind != kind:
                    ctx.report(src.relpath, pline, (
                        f"argument {i} of {name} is {ckind!r} here but "
                        f"{kind!r} in SIGNATURES ({cfg.kernel_build}:{line})"
                        " — ctypes would pass the wrong width"))
        ret = re.sub(r'extern\s+"C"|\bstatic\b|\binline\b', "",
                     fn.header).split()
        if restype != "int" or ret != ["int"]:
            ctx.report(cfg.kernel_build, line, (
                f"{name} must return int (the launch's cudaError) with "
                f"restype c_int; it returns {' '.join(ret)!r}, restype "
                f"{restype!r}"))
    for name, defs in sorted(entries.items()):
        if name not in sigs:
            for src, fn in defs:
                ctx.report(src.relpath, fn.line, (
                    f"extern \"C\" entry {name} has no SIGNATURES row in "
                    f"{cfg.kernel_build}: ctypes would guess int arguments"))

    # 2. ops._launch argument counts
    ops = _module(ctx, cfg.kernel_ops)
    for node in ast.walk(ops.tree) if ops is not None else ():
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_launch" and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)):
            continue
        entry = node.args[1].value
        if any(isinstance(a, ast.Starred) for a in node.args):
            continue
        if entry not in sigs:
            ctx.report(cfg.kernel_ops, node.lineno, (
                f"_launch of {entry!r}, which has no SIGNATURES row"))
            continue
        want = len(sigs[entry][0]) - 1
        got = len(node.args) - 2
        if got != want:
            ctx.report(cfg.kernel_ops, node.lineno, (
                f"_launch({entry!r}) passes {got} arguments; SIGNATURES "
                f"declares {want} before the stream _launch appends"))

    # 3–6. the launches in each source
    for src in sources:
        reaches = _reaches_launch(src)
        for fn in src.functions:
            params = _param_names(fn)
            for ln in _launches(src, fn):
                line = src.line_of(ln.offset)
                stream = _uncast(ln.stream) if ln.stream else None
                if stream is None or stream in _NO_STREAM:
                    ctx.report(src.relpath, line, (
                        f"{ln.kernel} is launched on the legacy default "
                        "stream — pass the entry's stream"))
                elif stream not in params:
                    ctx.report(src.relpath, line, (
                        f"{ln.kernel} is launched on {stream!r}, not on a "
                        f"stream {fn.name} was given"))
                bound = _launch_bounds(src, ln.kernel)
                if bound is not None and ln.block is not None and \
                        " ".join(bound.split()) != " ".join(ln.block.split()):
                    want, got = src.evaluate(bound), src.evaluate(ln.block)
                    if want is not None and got is not None and want != got:
                        ctx.report(src.relpath, line, (
                            f"{ln.kernel} has __launch_bounds__({want}) but "
                            f"is launched with {got} threads a block"))
                smem = src.evaluate(ln.smem) if ln.smem else None
                if smem is not None and smem > _BIG_SMEM and \
                        not _sets_smem(src, fn, ln.kernel):
                    ctx.report(src.relpath, line, (
                        f"{ln.kernel} asks for {smem} bytes of dynamic "
                        "shared memory without cudaFuncSetAttribute(..., "
                        "cudaFuncAttributeMaxDynamicSharedMemorySize, ...): "
                        "past 48 KB the launch fails"))
                after = fn.body[ln.end - fn.body_start:]
                if ln.kind == "chevron" and not re.search(
                        r"\bcuda(?:GetLastError|PeekAtLastError)\s*\(",
                        after):
                    ctx.report(src.relpath, line, (
                        f"the launch of {ln.kernel} is never checked: read "
                        "cudaGetLastError() after it and return it"))
                if ln.kind == "ex":
                    head = fn.body[:ln.offset - fn.body_start]
                    stmt = head[max(head.rfind(";"), head.rfind("{"),
                                    head.rfind("}")) + 1:]
                    if "=" not in stmt and "return" not in stmt:
                        ctx.report(src.relpath, line, (
                            "cudaLaunchKernelEx's result is dropped — "
                            "return it or check it"))
            if not reaches.get(fn.name):
                continue
            for m in re.finditer(r"\breturn\s+([^;]*);", fn.body):
                value = _uncast(m.group(1))
                if re.fullmatch(r"0|cudaSuccess", value):
                    ctx.report(src.relpath,
                               src.line_of(fn.body_start + m.start()), (
                                   f"{fn.name} reaches a kernel launch but "
                                   f"returns {m.group(1).strip()}: the "
                                   "launch's error never reaches the "
                                   "caller"))
