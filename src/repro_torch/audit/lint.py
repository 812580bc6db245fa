"""Repo lint pack: AST rules for the layering the port's audits rely on.

Counterpart of ``repro/audit/lint.py``, with its five rules applied to
the port's paths and one rule of the port's own:

* **plan-trace-free**: ``core/plan.py`` imports neither torch nor jax.
  The audit compares static pure-numpy plan tables with traced programs;
  a plan that could trace makes the comparison circular.
* **db-stdlib-only**: ``tune/db.py`` imports no torch or jax (module
  level or inline): it is read where no device runtime is installed.
* **kernel-dtype-literal**: ``kernels/*.py`` hardcode no narrow ladder
  dtype (``torch.float16`` / ``torch.bfloat16`` / ``torch.int8``) and no
  magic range constant (``65504``); they come from
  ``repro_torch.core.precision.DTYPES`` / ``RMAX``, so that a ladder
  change (f8) lands in one table. f32/f64 literals are fine:
  accumulators and routing are genuinely fixed-width.
* **search-injected-timer**: ``tune/search.py`` touches the wall clock
  only inside the injected-timer default (``timeit``); elsewhere timing
  flows through the ``timer`` parameter, and RNG is seeded.
* **serve-public-surface**: callers outside ``src/repro_torch/serve/``
  (the rest of the package and ``chip_smoke.py``) import serving names
  only from ``repro_torch.serve``, never from its submodules.
* **port-imports**: no module of ``src/repro_torch/`` and nothing in
  ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``: the
  port runs where neither is installed, and keeps its own copy of what it
  needs from them.

Suppress a single line with ``# audit: allow(<rule>)``.

Stdlib-only (``ast`` + ``re``).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.audit.report import CheckResult, Violation

#: narrow dtype attribute names banned in kernels/ (wide ones routed)
_NARROW_ATTRS = {"float16", "half", "bfloat16", "int8", "float8_e4m3fn",
                 "float8_e5m2"}
#: modules whose attributes name dtypes
_DTYPE_MODULES = ("torch", "np", "jnp", "jax")
#: magic f16 range constant (RMAX["f16"])
_MAGIC_CONSTS = {65504, 65504.0}

_ALLOW_RE = re.compile(r"#\s*audit:\s*allow\(([a-z0-9-]+)\)")

RULES = ("plan-trace-free", "db-stdlib-only", "kernel-dtype-literal",
         "search-injected-timer", "serve-public-surface", "port-imports")

#: repro_torch.serve submodules that are implementation layout, not API
_SERVE_SUBMODULES = {"engine", "scheduler", "metrics", "frontend",
                     "options"}


def repo_root() -> Path:
    """``src/``'s parent: the directory holding ``pyproject.toml``."""
    return Path(__file__).resolve().parents[3]


def _allows(source_lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source_lines, 1):
        for m in _ALLOW_RE.finditer(line):
            out.setdefault(i, set()).add(m.group(1))
    return out


def _imported(node) -> tuple:
    """The module names an import statement names."""
    if isinstance(node, ast.Import):
        return tuple(a.name for a in node.names)
    if isinstance(node, ast.ImportFrom) and node.module and not node.level:
        return (node.module,)
    return ()


def _is(mod: str, top: str) -> bool:
    return mod == top or mod.startswith(top + ".")


class _Lint:
    def __init__(self, path: Path, rel: str):
        self.path, self.rel = path, rel
        src = path.read_text()
        self.tree = ast.parse(src, filename=str(path))
        self.allows = _allows(src.splitlines())
        self.viols: list[Violation] = []

    def flag(self, rule: str, node: ast.AST, msg: str):
        line = getattr(node, "lineno", 0)
        if rule in self.allows.get(line, ()):
            return
        self.viols.append(Violation(rule, self.rel, msg,
                                    path=self.rel, line=line))

    # -- rule bodies -------------------------------------------------------
    def no_imports(self, rule: str, tops: tuple, why: str):
        for node in ast.walk(self.tree):
            for mod in _imported(node):
                if any(_is(mod, t) for t in tops):
                    self.flag(rule, node,
                              f"imports {mod} at line {node.lineno}; {why}")

    def no_narrow_dtype_literals(self):
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in _DTYPE_MODULES
                    and node.attr in _NARROW_ATTRS):
                self.flag(
                    "kernel-dtype-literal", node,
                    f"hardcoded {node.value.id}.{node.attr} at line "
                    f"{node.lineno}; use repro_torch.core.precision.DTYPES "
                    "so ladder growth lands in one table")
            elif (isinstance(node, ast.Constant)
                    and type(node.value) in (int, float)
                    and node.value in _MAGIC_CONSTS):
                self.flag(
                    "kernel-dtype-literal", node,
                    f"magic range constant {node.value} at line "
                    f"{node.lineno}; use repro_torch.core.precision.RMAX")

    def serve_surface_only(self):
        why = ("serving names are public only via repro_torch.serve; "
               "submodule layout is private")
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith("repro_torch.serve."):
                        self.flag("serve-public-surface", node,
                                  f"imports {a.name} at line "
                                  f"{node.lineno}; {why}")
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module.startswith("repro_torch.serve."):
                    self.flag("serve-public-surface", node,
                              f"imports from {node.module} at line "
                              f"{node.lineno}; {why}")
                elif node.module == "repro_torch.serve":
                    for a in node.names:
                        if a.name in _SERVE_SUBMODULES:
                            self.flag(
                                "serve-public-surface", node,
                                f"from repro_torch.serve import {a.name} "
                                f"at line {node.lineno} reaches the "
                                f"submodule; {why}")

    def timer_confined(self):
        stack: list[str] = []

        def visit(node):
            is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            if is_fn:
                stack.append(node.name)
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in ("time", "datetime")
                    and "timeit" not in stack):
                self.flag(
                    "search-injected-timer", node,
                    f"wall-clock access {node.value.id}.{node.attr} at "
                    f"line {node.lineno} outside the injected-timer "
                    "default; route timing through the timer parameter")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "default_rng"
                    and not node.args and not node.keywords):
                self.flag(
                    "search-injected-timer", node,
                    f"unseeded default_rng() at line {node.lineno}; "
                    "tuning runs must be replayable: pass a seed")
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_fn:
                stack.pop()

        visit(self.tree)


def lint_repo(root: Path | None = None) -> CheckResult:
    """Run every rule; returns one CheckResult for the lint pack."""
    root = Path(root) if root else repo_root()
    src = root / "src" / "repro_torch"
    viols: list[Violation] = []

    def run(path: Path, fn, *args):
        rel = str(path.relative_to(root))
        if not path.exists():
            viols.append(Violation("lint-missing-file", rel,
                                   f"{rel} not found", severity="warn"))
            return
        lint = _Lint(path, rel)
        fn(lint, *args)
        viols.extend(lint.viols)

    run(src / "core" / "plan.py", _Lint.no_imports, "plan-trace-free",
        ("torch", "jax"), "plans must stay static pure-numpy tables")
    run(src / "tune" / "db.py", _Lint.no_imports, "db-stdlib-only",
        ("torch", "jax"), "the database is read without a device runtime")
    for kp in sorted((src / "kernels").glob("*.py")):
        run(kp, _Lint.no_narrow_dtype_literals)
    run(src / "tune" / "search.py", _Lint.timer_confined)
    port = sorted(src.rglob("*.py")) + [root / "chip_smoke.py"]
    for p in port:
        run(p, _Lint.no_imports, "port-imports", ("jax", "repro"),
            "the port imports nothing of JAX or of the JAX package")
    # serve-public-surface sweeps everything outside the serve package
    # itself; tests/ stay exempt (white-box tests reach into internals)
    for p in port:
        if "serve" not in p.relative_to(root).parts[2:3]:
            run(p, _Lint.serve_surface_only)
    return CheckResult("lint", "src/repro_torch", viols)


if __name__ == "__main__":
    import sys
    res = lint_repo()
    for v in res.violations:
        print(v)
    print(f"lint pack: {len(res.violations)} finding(s)")
    sys.exit(0 if res.ok else 1)
