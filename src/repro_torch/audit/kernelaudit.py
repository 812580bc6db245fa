"""Static checks of the Hopper kernels: accumulators, resources, bounds.

Counterpart of ``repro/audit/kernelaudit.py``, whose three rules read the
Pallas calls' specs. The port's kernels are CUDA C++ under
``kernels/csrc``; their counterparts of those rules:

* **kernel-accumulator-dtype** (here): every ``wgmma.mma_async`` /
  ``mma.sync`` PTX string accumulates in f32 (s32 for s8 operands, f64
  for f64 ones): a 16-bit D type halves the mantissa of every partial
  sum, and no numeric test at leaf-sized n catches it. On the CUDA cores,
  every accumulator array (``acc``) and the accumulator type of every
  instantiation of the GEMM cores (``csrc/simt_gemm.cuh``'s ``sg_block``,
  ``sg_block_async``, ``sg_mma``; ``csrc/common.cuh``'s ``gemm_block``)
  resolves, through the sources' template arguments, macro arguments and
  accumulator traits (``AccOf``), to f32, f64 or s32.
* **kernel-smem-budget** (on the card): each compiled kernel's static
  shared memory, registers and local memory (spills) from
  ``cuobjdump --dump-resource-usage`` of the built libraries, and its
  dynamic shared memory from the library's own list (``smem_table``,
  ``csrc/common.cuh``), where each launcher states the size it passes
  to ``cudaFuncSetAttribute`` and to its launches, whether it launches
  or not. Static plus dynamic is held against the H100's 232,448 B a
  block for every compiled kernel, the registers against 255 a thread;
  local memory is a warning. A compiled kernel that no launcher lists, a
  listed one that is not compiled, and a launch (CUPTI's record, through
  ``torch.profiler``) of a kernel the table does not hold or with other
  shared memory than the table's are errors.
* **kernel-index-bounds** (here): the Python launch plans evaluated at the
  paper's geometries (leaf 128 and 256, n up to 32768): ``trsm.plan``'s
  work items, the triangular decode of ``syrk_packed``'s grids
  (``csrc/common.cuh:tri_decode``, modelled in :func:`tri_decode`) and
  ``panel.plan``'s pair tables. Every tile lies inside its operand, every
  lower tile is covered the expected number of times, and every packed
  index fits its bit field.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch.audit.report import CheckResult, Violation

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

#: the H100's shared memory a block may take (opt-in) and registers a thread
SMEM_LIMIT = 232448
REG_LIMIT = 255
#: shared memory sm_90 reserves for the system in every block: cuobjdump's
#: SHARED counts it (a kernel with no __shared__ array, qgemm_tc_kernel,
#: reads 1024), CUPTI's launch record and SMEM_LIMIT do not
RESERVED_SMEM = 1024

#: accumulator types the rules accept
_ACC_OK = {"float", "double", "int", "int32_t"}
#: the GEMM cores and the position of their accumulator template argument
_CORES = {"sg_block": 1, "sg_block_async": 1, "sg_mma": 1, "gemm_block": 1}

_WGMMA_RE = re.compile(
    r"wgmma\.mma_async\.sync\.aligned\.m\d+n\d+k\d+\.(\w+)((?:\.\w+)*)")
_MMA_RE = re.compile(
    r"\bmma\.sync\.aligned\.m\d+n\d+k\d+((?:\.(?:row|col))*)\.(\w+)"
    r"((?:\.\w+)*)")


# ---------------------------------------------------------------------------
# source model: comments out, functions and macros with their parameters
# ---------------------------------------------------------------------------
def _strip_comments(text: str) -> str:
    """Comments replaced by spaces (positions and lines kept); string
    literals are kept (the PTX lives in them)."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _split_args(s: str) -> list:
    """Top-level comma split of a template or macro argument list."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "<([{":
            depth += 1
        elif ch in ">)]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _close(text: str, i: int, open_ch: str, close_ch: str) -> int:
    """Index of the bracket closing the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_ch:
            depth += 1
        elif text[j] == close_ch:
            depth -= 1
            if depth == 0:
                return j
    return -1


def _param_name(decl: str) -> str:
    m = re.search(r"(\w+)\s*(?:=.*)?$", decl.strip())
    return m.group(1) if m else decl.strip()


class _Scope:
    """A template function or struct, or a macro, with its parameter
    names, over a span of one source."""

    def __init__(self, kind, name, params, path, start, end):
        self.kind, self.name, self.params = kind, name, params
        self.path, self.start, self.end = path, start, end


class _Sources:
    def __init__(self, csrc: Path):
        self.files = {p.name: _strip_comments(p.read_text())
                      for p in sorted(csrc.glob("*.cu*"))}
        self.scopes: list[_Scope] = []
        self.traits: dict[str, list] = {}     # trait -> typedef'd types
        for name, text in self.files.items():
            self._scan(name, text)

    def _scan(self, path, text):
        code = list(text)
        for m in re.finditer(r"^[ \t]*#[ \t]*define[ \t]+(\w+)(\(([^)]*)\))?"
                             r"(?:[^\n]*\\\n)*[^\n]*", text, re.M):
            params = ([_param_name(p) for p in m.group(3).split(",")]
                      if m.group(2) else [])
            self.scopes.append(_Scope("macro", m.group(1), params, path,
                                      m.start(), m.end()))
            for k in range(m.start(), m.end()):
                if code[k] != "\n":
                    code[k] = " "
        for m in re.finditer(r"^[ \t]*#[^\n]*", text, re.M):
            for k in range(m.start(), m.end()):
                code[k] = " "
        code = re.sub(r'"(?:\\.|[^"\\\n])*"',          # strings' braces
                      lambda m: " " * len(m.group(0)), "".join(code))
        for m in re.finditer(r"struct\s+(\w+)\s*(<[^{;]*>)?\s*\{\s*typedef\s+"
                             r"([^;]+?)\s+type\s*;", code):
            self.traits.setdefault(m.group(1), []).append(m.group(3))
        depth, last, i, opened = 0, 0, 0, 0
        while i < len(code):
            ch = code[i]
            if ch == "{":
                if depth == 0 and re.fullmatch(r"\s*(namespace\b\s*\w*|extern"
                                               r"\s*)\s*", code[last:i]):
                    opened += 1         # a namespace's braces hold entities
                    last = i + 1
                elif depth == 0:
                    self._entity(path, code, last, i)
                    depth += 1
                else:
                    depth += 1
            elif ch == "}" and depth == 0 and opened:
                opened -= 1
                last = i + 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    last = i + 1
                    if self.scopes and self.scopes[-1].end is None:
                        self.scopes[-1].end = i
            elif ch == ";" and depth == 0:
                last = i + 1
            i += 1

    def _entity(self, path, code, start, brace):
        header = code[start:brace]
        params = []
        t = re.search(r"template\s*<", header)
        if t:
            close = _close(header, t.end() - 1, "<", ">")
            params = [_param_name(p)
                      for p in _split_args(header[t.end():close])]
            rest = header[close + 1:]
        else:
            rest = header
        s = re.search(r"\b(?:struct|class)\s+(\w+)", rest)
        if s and "(" not in rest[:s.start()]:
            name, kind = s.group(1), "struct"
        else:
            # the parameter list is the paren group that ends the header;
            # the function's name stands right before it
            name, kind = None, "function"
            end = rest.rfind(")")
            depth = 0
            for k in range(end, -1, -1):
                depth += {")": 1, "(": -1}.get(rest[k], 0)
                if depth == 0:
                    m = re.search(r"(\w+)\s*$", rest[:k])
                    name = m.group(1) if m else None
                    break
        if name:
            self.scopes.append(_Scope(kind, name, params, path, start, None))

    def scope_at(self, path, pos):
        """The innermost macro, else the top-level entity, holding pos."""
        best = None
        for s in self.scopes:
            if s.path == path and s.start <= pos <= (s.end or pos):
                if s.kind == "macro":
                    return s
                best = s
        return best

    def _visible(self, def_path):
        """The sources that see a definition in ``def_path``: a ``.cu``
        file's own templates and macros are its own; a header's are
        everyone's."""
        if def_path.endswith(".cu"):
            return [(def_path, self.files[def_path])]
        return list(self.files.items())

    def sites(self, name, def_path):
        """``(path, pos, args)`` of every ``name<args>`` that sees the
        definition in ``def_path`` (an explicit instantiation, a call or
        a reference)."""
        pat = re.compile(r"\b" + re.escape(name) + r"\s*<")
        for path, text in self._visible(def_path):
            for m in pat.finditer(text):
                close = _close(text, m.end() - 1, "<", ">")
                if close > 0:
                    yield path, m.start(), _split_args(text[m.end():close])

    def macro_calls(self, name, def_path):
        pat = re.compile(r"\b" + re.escape(name) + r"\s*\(")
        for path, text in self._visible(def_path):
            for m in pat.finditer(text):
                if re.match(r"[ \t]*#[ \t]*define", text[text.rfind(
                        "\n", 0, m.start()) + 1:m.start()]):
                    continue            # the definition itself
                close = _close(text, m.end() - 1, "(", ")")
                if close > 0:
                    yield path, m.start(), _split_args(text[m.end():close])

    def resolve(self, arg: str, path: str, pos: int, seen=None) -> set:
        """The concrete types ``arg`` (a type written at ``pos``) takes
        in the sources; ``"?"`` where a binding cannot be followed."""
        seen = {} if seen is None else seen
        arg = re.sub(r"\b(typename|const|volatile)\b", "", arg).strip()
        key = (arg, path, pos)
        if key not in seen:
            seen[key] = set()           # a cycle adds nothing
            seen[key] = self._resolve(arg, path, pos, seen)
        return seen[key]

    def _resolve(self, arg, path, pos, seen) -> set:
        tm = re.fullmatch(r"(\w+)\s*<.*>\s*::\s*type", arg)
        if tm:
            out = set()
            for t in self.traits.get(tm.group(1), ["?"]):
                out |= self.resolve(t, path, -1, seen)
            return out
        if not re.fullmatch(r"\w+", arg):
            return {arg}
        scope = self.scope_at(path, pos) if pos >= 0 else None
        if scope is None:
            return {arg}                # a concrete type (or an alias)
        out = set()
        if arg not in scope.params:
            if scope.kind != "macro":
                # a local alias: typedef X arg; / using arg = X;
                body = self.files[path][scope.start:scope.end]
                m = re.search(r"typedef\s+([^;]+?)\s+" + arg + r"\s*;|using\s+"
                              + arg + r"\s*=\s*([^;]+);", body)
                if m:
                    return self.resolve(m.group(1) or m.group(2), path,
                                        scope.start + m.start(), seen)
                return {arg}
            # a name the macro does not bind: the expansion's context's
            calls = list(self.macro_calls(scope.name, scope.path))
            for spath, spos, _ in calls:
                out |= self.resolve(arg, spath, spos, seen)
            return out if calls else {"?"}
        k = scope.params.index(arg)
        found = (self.macro_calls(scope.name, scope.path)
                 if scope.kind == "macro"
                 else self.sites(scope.name, scope.path))
        followed = 0
        for spath, spos, args in found:
            if scope.path == spath and scope.start <= spos <= (
                    scope.end or spos) and scope.kind != "macro":
                continue                # the template's own definition
            if k < len(args):
                followed += 1
                out |= self.resolve(args[k], spath, spos, seen)
        return out if followed else {"?"}


def accumulator_violations(csrc: Path, target: str = "kernels") -> list:
    """kernel-accumulator-dtype over every source under ``csrc``."""
    src = _Sources(Path(csrc))
    viols, nptx = [], 0

    def where(path, pos):
        return path, src.files[path].count("\n", 0, pos) + 1

    for path, text in src.files.items():
        for m in _WGMMA_RE.finditer(text):
            nptx += 1
            d, rest = m.group(1), m.group(2)
            ok = d == "f32" or (d == "s32" and re.match(r"\.[su]8\.", rest
                                                        + "."))
            if not ok:
                p, line = where(path, m.start())
                viols.append(Violation(
                    "kernel-accumulator-dtype", target,
                    f"{p}:{line}: wgmma accumulates in .{d}{rest}; partial "
                    "sums must accumulate in f32 (s32 for s8)",
                    path=p, line=line))
        for m in _MMA_RE.finditer(text):
            nptx += 1
            d, rest = m.group(2), m.group(3)
            ok = (d == "f32"
                  or (d == "s32" and re.match(r"\.[su]8\.", rest + "."))
                  or (d == "f64" and rest.startswith(".f64")))
            if not ok:
                p, line = where(path, m.start())
                viols.append(Violation(
                    "kernel-accumulator-dtype", target,
                    f"{p}:{line}: mma.sync accumulates in .{d}{rest}; "
                    "partial sums must accumulate in f32 (s32 for s8, "
                    "f64 for f64)", path=p, line=line))
    sites = []
    for core, k in _CORES.items():
        for path, pos, args in src.sites(core, "core.cuh"):
            if k < len(args):
                sites.append((path, pos, args[k], f"{core}<> accumulator"))
    for path, text in src.files.items():
        for m in re.finditer(r"(?:^|[;{(]\s*|\n\s*)((?:typename\s+)?[\w:<>]+"
                             r")\s+(acc\w*)\s*\[", text):
            sites.append((path, m.start(1), m.group(1), m.group(2)))
    for path, pos, arg, what in sites:
        types = src.resolve(arg, path, pos)
        bad = sorted(t for t in types if t not in _ACC_OK)
        if bad:
            p, line = where(path, pos)
            viols.append(Violation(
                "kernel-accumulator-dtype", target,
                f"{p}:{line}: {what} of type {arg!r} "
                + ("could not be followed to a concrete type"
                   if bad == ["?"] else f"takes {bad}")
                + "; accumulators must be f32, f64 or s32",
                path=p, line=line))
    if nptx == 0 or not sites:
        viols.append(Violation(
            "kernel-untestable", target,
            f"found {nptx} mma strings and {len(sites)} accumulators under "
            f"{csrc}: the sources were not where the audit looked"))
    return viols


# ---------------------------------------------------------------------------
# index bounds of the Python launch plans
# ---------------------------------------------------------------------------
#: the paper's geometries: leaf tiles and matrix sizes
LEAVES = (128, 256)
SIZES = (1024, 4096, 16384, 32768)
#: panels checked at every size; every panel below this many tiles
_ALL_PANELS_BELOW = 64


def tri_decode(t: int) -> tuple:
    """``csrc/common.cuh:tri_decode``: the t-th lower tile (i, j), i >= j,
    row by row, in the same double-precision arithmetic."""
    r = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > t:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= t:
        r += 1
    return r, t - r * (r + 1) // 2


def trsm_violations(M: int, n: int, dtype, target: str) -> list:
    """``trsm.plan(M, n)``'s work items: each column block inside [0, n),
    its k-chunk inside the block's triangle [0, n1), the chunks of a block
    in order and covering it, at most ``plan.chunks`` of them."""
    from repro_torch.kernels import trsm
    p = trsm.plan(M, n, dtype)
    items = trsm.work_items(n, p.tile[1], p.kc)
    viols, cover = [], {}
    for n0, n1, k0, k1 in items:
        if not (0 <= n0 < n1 <= n and 0 <= k0 < k1 <= n1
                and n1 - n0 <= p.tile[1]):
            viols.append(Violation(
                "kernel-index-bounds", target,
                f"trsm_leaf M={M} n={n}: item (n {n0}:{n1}, k {k0}:{k1}) "
                f"outside the {M} x {n} operand's triangle"))
        cover.setdefault((n0, n1), []).append((k0, k1))
    for (n0, n1), ks in cover.items():
        ks.sort()
        if ks[0][0] != 0 or ks[-1][1] != n1 or any(
                a[1] != b[0] for a, b in zip(ks, ks[1:])) or len(ks) > max(
                p.chunks, 1):
            viols.append(Violation(
                "kernel-index-bounds", target,
                f"trsm_leaf M={M} n={n}: column block {n0}:{n1} takes "
                f"k-chunks {ks}, not one cover of [0, {n1}) in at most "
                f"{p.chunks}"))
    return viols


def syrk_packed_violations(n: int, a_dtype, c_dtype, target: str) -> list:
    """``syrk.packed_plan``'s grid through :func:`tri_decode`: every CTA's
    tile inside the lower triangle of the padded (n, n) output, every
    lower tile covered once (twice on the tensor cores: two 128-row halves
    of a 256 x 256 tile)."""
    from repro_torch.kernels import syrk
    p = syrk.packed_plan(n, n, a_dtype, c_dtype, "k")
    viols, seen = [], {}
    if p.route.startswith("tc"):
        bm, bn = syrk.TC_TILE
        nt = -(-n // bn)
        want_ctas, halves = nt * (nt + 1), 2
        for x in range(p.ctas):
            bi, bj = tri_decode(x >> 1)
            m0, n0 = bn * bi + bm * (x & 1), bn * bj
            if not (0 <= bj <= bi < nt and m0 + bm <= nt * bn
                    and n0 + bn <= nt * bn):
                viols.append(Violation(
                    "kernel-index-bounds", target,
                    f"syrk_packed n={n} tc: CTA {x} -> tile ({bi}, {bj}) "
                    f"rows {m0}, cols {n0}: outside the {nt}-tile lower "
                    "triangle"))
                break
            seen[(bi, bj)] = seen.get((bi, bj), 0) + 1
    else:
        b = p.tile[0]
        nt = -(-n // b)
        want_ctas, halves = nt * (nt + 1) // 2, 1
        for t in range(p.ctas):
            i, j = tri_decode(t)
            if not 0 <= j <= i < nt:
                viols.append(Violation(
                    "kernel-index-bounds", target,
                    f"syrk_packed n={n} simt: CTA {t} -> tile ({i}, {j}) "
                    f"outside the {nt}-tile lower triangle"))
                break
            seen[(i, j)] = seen.get((i, j), 0) + 1
    if p.ctas != want_ctas or len(seen) != nt * (nt + 1) // 2 or any(
            v != halves for v in seen.values()):
        viols.append(Violation(
            "kernel-index-bounds", target,
            f"syrk_packed n={n} {p.route}: {p.ctas} CTAs cover "
            f"{len(seen)} lower tiles of {nt * (nt + 1) // 2}, each "
            f"{sorted(set(seen.values()))} times; want {want_ctas} CTAs, "
            f"each tile {halves} time(s)"))
    return viols


def panel_violations(plan, nt: int, b: int, dtype, target: str,
                     what: str = "") -> list:
    """One ``panel.plan``: every tc pair and simt item inside the panel's
    ``nt`` trailing row tiles (i >= j), every lower pair covered once
    (each simt sub-block once), slots and sub-blocks in range, and every
    packed field (``(i << 16) | j``, ``(slot << 16) | (code << 8) | sub``)
    inside its bits."""
    from repro_torch.kernels import panel
    nsub = (b // panel.simt_tile(dtype, b)) ** 2
    viols, seen = [], {}

    def bad(msg):
        viols.append(Violation("kernel-index-bounds", target,
                               f"panel_update {what}: {msg}"))
    for s, pairs in enumerate(plan.tc_pairs):
        for i, j in pairs:
            if not (0 <= j <= i < nt and i < 1 << 16):
                bad(f"tc pair ({i}, {j}) of slot {s} outside the {nt} "
                    "trailing row tiles")
            seen[(i, j)] = seen.get((i, j), 0) + nsub
    for i, j, s, code, sub in plan.simt_items:
        if not (0 <= j <= i < nt and i < 1 << 16 and 0 <= s < len(
                plan.slots) and s < 1 << 15 and 0 <= code < 1 << 8
                and (sub == panel.SUB_ALL or 0 <= sub < nsub)):
            bad(f"simt item ({i}, {j}, slot {s}, code {code}, sub {sub}) "
                f"outside the {nt} trailing row tiles / {len(plan.slots)} "
                f"slots / {nsub} sub-blocks")
        seen[(i, j)] = seen.get((i, j), 0) + (
            nsub if sub == panel.SUB_ALL else 1)
    want = nt * (nt + 1) // 2
    if len(seen) != want or any(v != nsub for v in seen.values()):
        bad(f"{len(seen)} of {want} lower pairs covered, sub-blocks "
            f"{sorted(set(seen.values()))} a pair (want {nsub})")
    return viols


def index_violations(target: str) -> list:
    """kernel-index-bounds over the paper's geometries."""
    import torch

    from repro_torch.core.plan import build_plan
    from repro_torch.core.precision import DTYPES, PAPER_CONFIGS
    from repro_torch.kernels import panel
    viols = []
    for dt in (torch.float32, torch.float64):
        for b in LEAVES:
            for m in sorted({b * 2 ** k for k in range(8)} | {max(SIZES)}):
                viols += trsm_violations(m, b, dt, target)
    for n in SIZES + (1000,):
        for a_dt, c_dt in ((DTYPES["bf16"], torch.float32),
                           (DTYPES["int8"], torch.float32),
                           (torch.float32, torch.float32),
                           (torch.float64, torch.float64)):
            viols += syrk_packed_violations(n, a_dt, c_dt, target)
    for key in ("f16x3_f32", "bf16_f32", "int8_f32", "pure_f32",
                "f32x3_f64"):
        for b in LEAVES:
            cfg = dataclasses.replace(PAPER_CONFIGS[key], leaf=b)
            for n in SIZES:
                pl = build_plan(n, cfg)
                T = pl.ntiles
                panels = (range(T - 1) if T <= _ALL_PANELS_BELOW
                          else sorted({0, 1, T // 2, T - 3, T - 2}))
                for p in panels:
                    meta = pl.panel_meta(p)
                    pp = panel.plan(meta.pair_names, meta.pair_quants,
                                    cfg.high_dtype, b)
                    viols += panel_violations(
                        pp, T - p - 1, b, cfg.high_dtype, target,
                        f"{key} n={n} leaf={b} panel {p}")
    return viols


def audit_kernels() -> CheckResult:
    """The two checks that run without a card: accumulator types and the
    launch plans' index bounds."""
    target = "kernels[csrc]"
    viols = accumulator_violations(CSRC, target)
    viols += index_violations(target)
    return CheckResult("kernels", target, viols)


# ---------------------------------------------------------------------------
# resources on the card
# ---------------------------------------------------------------------------
def _tool(name: str):
    found = shutil.which(name)
    if found:
        return found
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base and os.path.exists(os.path.join(base, "bin", name)):
            return os.path.join(base, "bin", name)
    return None


def _demangle(names: list) -> dict:
    """Mangled -> demangled names, through cu++filt or c++filt (the
    names themselves where neither is installed)."""
    tool = _tool("cu++filt") or _tool("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    lines = out.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {
        n: n for n in names}


def kernel_key(name: str) -> str:
    """A kernel's name without its return type, parameters, namespace of
    an unnamed namespace and spaces, its template arguments as CUPTI
    prints them: ``void panel_tc<float, 128>(const float*, ...)`` and
    cu++filt's ``panel_tc<float, (int)128>`` -> ``panel_tc<float,128>``;
    ``(bool)1`` -> ``true``."""
    name = re.sub(r"^\s*void\s+", "", name)
    name = re.sub(r"<unnamed>::|\(anonymous namespace\)::", "", name)
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    name = re.sub(r"\((?:unsigned |signed )?(?:int|long|long long|short|"
                  r"char)\)(?=-?\d)", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return re.sub(r"\s+", "", name)


def parse_resource_usage(text: str) -> list:
    """Rows of ``cuobjdump --dump-resource-usage``: the mangled name and
    its REG, SHARED (static, less :data:`RESERVED_SMEM`), LOCAL and STACK
    values."""
    rows, name = [], None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s+(\S+?):\s*$", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            vals = {k: int(v) for k, v in
                    re.findall(r"(\w+(?:\[\d+\])?):(\d+)", line)}
            rows.append({"mangled": name, "regs": vals.get("REG", 0),
                         "static_smem": max(vals.get("SHARED", 0)
                                            - RESERVED_SMEM, 0),
                         "local_bytes": vals.get("LOCAL", 0),
                         "stack_bytes": vals.get("STACK", 0)})
            name = None
    return rows


def resource_usage(libs: dict) -> list:
    """One row a compiled kernel of the built libraries (``libs``: stem ->
    path): ``cuobjdump --dump-resource-usage``, names demangled."""
    tool = _tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found: the resource table is "
                           "read where the CUDA toolkit is installed")
    rows = []
    for stem, path in sorted(libs.items()):
        out = subprocess.run([tool, "--dump-resource-usage", str(path)],
                             capture_output=True, text=True, check=True)
        for r in parse_resource_usage(out.stdout):
            rows.append({"lib": stem, **r})
    names = _demangle([r["mangled"] for r in rows])
    for r in rows:
        r["kernel"] = kernel_key(names[r.pop("mangled")])
    return rows


def listed_smem(libs: dict) -> list:
    """Each loaded library's list of the kernels its launchers start
    (``smem_table``, ``csrc/common.cuh``; ``libs``: stem -> CDLL): one row
    a kernel, its dynamic shared memory and whether that is a bound."""
    import ctypes
    rows = []
    name, nbytes, bound = ctypes.c_char_p(), ctypes.c_int(), ctypes.c_int()
    for stem, lib in sorted(libs.items()):
        fn = lib.smem_table
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        count = fn(-1, None, None, None)
        for i in range(count):
            got = fn(i, ctypes.byref(name), ctypes.byref(nbytes),
                     ctypes.byref(bound))
            if got < 0:
                raise RuntimeError(f"{stem}: smem_table({i}) could not read "
                                   f"the kernel's name (cudaError {-1 - got})")
            rows.append({"lib": stem, "mangled": name.value.decode(),
                         "dynamic_smem": nbytes.value,
                         "bound": bool(bound.value)})
    names = _demangle([r["mangled"] for r in rows])
    for r in rows:
        r["kernel"] = kernel_key(names[r.pop("mangled")])
    return rows


def profiled_launches(fn) -> dict:
    """Run ``fn()`` under torch.profiler and read each launched kernel's
    registers a thread and shared memory a block (static + dynamic, as
    CUPTI records the launch): kernel key -> {"launches", "regs",
    "smem"} (maxima over its launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):             # the profiler's first events may
            torch.cuda._sleep(1)        # be lost; these take the loss
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    out: dict = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        args = ev.get("args", {})
        key = kernel_key(ev.get("name", ""))
        if "spin_kernel" in key or "sleep" in key:
            continue
        row = out.setdefault(key, {"launches": 0, "regs": 0, "smem": 0})
        row["launches"] += 1
        row["regs"] = max(row["regs"], int(args.get(
            "registers per thread", 0)))
        row["smem"] = max(row["smem"], int(args.get("shared memory", 0)))
    return out


def resource_table(rows: list, listed: list, launched: dict) -> list:
    """The compiled kernels' rows (:func:`resource_usage`) with the
    dynamic shared memory their launchers list (:func:`listed_smem`;
    None where none does; ``dynamic_bound``: a run-time size at most
    that) and their launches in the profiled work (``launch_smem`` the
    largest, None where the kernel did not launch)."""
    by = {}
    for e in listed:
        key = (e["lib"], e["kernel"])
        if key not in by or e["dynamic_smem"] > by[key]["dynamic_smem"]:
            by[key] = e
    table = []
    for r in rows:
        e = by.get((r["lib"], r["kernel"]))
        got = launched.get(r["kernel"])
        table.append({**r, "dynamic_smem": e["dynamic_smem"] if e else None,
                      "dynamic_bound": e["bound"] if e else False,
                      "launches": got["launches"] if got else 0,
                      "launch_smem": got["smem"] if got else None})
    return table


def _family(key: str) -> str:
    """A kernel key's name without its template arguments."""
    return key.split("<", 1)[0]


def audit_resources(table: list, listed: list, launched: dict,
                    target: str = "kernels[card]") -> CheckResult:
    """kernel-smem-budget over a :func:`resource_table`: every compiled
    kernel's static plus listed dynamic shared memory within
    :data:`SMEM_LIMIT`, its registers within :data:`REG_LIMIT`, local
    memory (spills) reported; a compiled kernel that no launcher lists, a
    listed kernel that is not compiled, a launch of one of the port's
    kernel templates that the table does not hold, profiled work none of
    whose launches the table holds, and a launch whose shared memory is
    not the table's (above it, for a bound) are errors."""
    viols = []

    def err(msg, severity="error"):
        viols.append(Violation("kernel-smem-budget", target, msg,
                               severity=severity))
    for r in table:
        name = f"{r['lib']}/{r['kernel']}"
        if r["dynamic_smem"] is None:
            err(f"{name}: no launcher lists its dynamic shared memory "
                "(csrc/common.cuh dyn_smem)")
            continue
        total = r["static_smem"] + r["dynamic_smem"]
        if total > SMEM_LIMIT:
            err(f"{name}: {total} B of shared memory a block "
                f"({r['static_smem']} static + {r['dynamic_smem']} dynamic"
                f"{' at most' if r['dynamic_bound'] else ''}) exceeds "
                f"{SMEM_LIMIT} B")
        if r["regs"] > REG_LIMIT:
            err(f"{name}: {r['regs']} registers a thread exceed {REG_LIMIT}")
        if r["local_bytes"]:
            err(f"{name}: {r['local_bytes']} B of local memory a thread "
                "(spills or a stack array)", severity="warn")
        got = r["launch_smem"]
        if got is not None and (got > total if r["dynamic_bound"]
                                else got != total):
            err(f"{name}: a launch took {got} B of shared memory; the "
                f"table gives {r['static_smem']} static + "
                f"{r['dynamic_smem']} dynamic"
                f"{' at most' if r['dynamic_bound'] else ''}")
    compiled = {(r["lib"], r["kernel"]) for r in table}
    for e in listed:
        if (e["lib"], e["kernel"]) not in compiled:
            err(f"{e['lib']}/{e['kernel']}: listed by a launcher, but no "
                "compiled kernel of that name")
    # PyTorch's own kernels launch in the profiled work too: a launch of
    # one of the port's kernel templates must join a compiled row, and the
    # work must reach some row, or the names no longer join
    known = {r["kernel"] for r in table}
    families = {_family(k) for k in known}
    for key, got in launched.items():
        if key not in known and _family(key) in families:
            err(f"{key}: launched ({got['launches']} times, {got['smem']} B "
                "of shared memory), but no compiled kernel of that name")
    if launched and not any(r["launches"] for r in table):
        err(f"none of the {len(launched)} kernels launched in the profiled "
            "work joins a compiled kernel")
    if not table or not listed:
        viols.append(Violation(
            "kernel-untestable", target,
            f"cuobjdump listed {len(table)} kernels and the launchers "
            f"{len(listed)}"))
    return CheckResult("kernel-resources", target, viols)


def card_resources(fn):
    """``(CheckResult, table, seconds)``: kernel-smem-budget over every
    compiled kernel, with the shared memory of the launches ``fn()``
    makes under the profiler; ``seconds``: the profiled work with the
    trace's export, and the table (the launchers' lists, cuobjdump, the
    names' demangling)."""
    import time

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    launched = profiled_launches(fn)
    t1 = time.perf_counter()
    libs = _build.build_all()
    listed = listed_smem(libs)
    table = resource_table(
        resource_usage({s: Path(lib._name) for s, lib in libs.items()}),
        listed, launched)
    seconds = {"profiled_s": t1 - t0, "table_s": time.perf_counter() - t1}
    return audit_resources(table, listed, launched), table, seconds
