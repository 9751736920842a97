"""The static check that the benchmark stands apart from JAX and keeps its
reference apart from the port.

It walks every module the benchmark runs: each Python file under
``portbench/`` (the tests aside) and, transitively, every module of
``src/repro_torch`` that those import, lazily inside functions too. It
reports any import whose top-level name, the part before the first dot, is
``jax``, ``jaxlib``, ``flax`` or ``repro``, compared whole (``repro_torch``
is the port), and any module of ``repro_torch`` that the reference under
``portbench/reference/`` reaches. ``run.py`` checks ``sys.modules`` at run
time as well.
"""

from __future__ import annotations

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def imports(path: Path, package: str) -> list[str]:
    """The absolute module names ``path`` imports (relative ones resolved
    against ``package``); ``from a import b`` names both ``a`` and ``a.b``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.append(base)
            out += [f"{base}.{a.name}" for a in node.names]
    return out


def module_file(name: str, roots: dict) -> Path | None:
    """The source file of ``name`` if it is one of the walked packages'."""
    top = name.split(".")[0]
    if top not in roots:
        return None
    base = roots[top].joinpath(*name.split(".")[1:])
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def walk(start: list[Path], roots: dict) -> dict[Path, list[str]]:
    """Every file reached from ``start`` through imports of the ``roots``
    packages, with the names each imports."""
    seen: dict[Path, list[str]] = {}
    todo = list(start)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        pkg_root = next(r for r in roots.values() if path.is_relative_to(r))
        package = ".".join(path.relative_to(pkg_root.parent).parts[:-1])
        names = imports(path, package)
        seen[path] = names
        for name in names:
            parts = name.split(".")
            for i in range(1, len(parts) + 1):  # each package on the way runs too
                f = module_file(".".join(parts[:i]), roots)
                if f is not None and f not in seen:
                    todo.append(f)
    return seen


def violations(root: Path = ROOT) -> list[str]:
    """What the check finds, one line each; empty when the tree is sound."""
    bench = root / "portbench"
    roots = {"portbench": bench, "repro_torch": root / "src" / "repro_torch"}
    files = [p for p in sorted(bench.rglob("*.py")) if "tests" not in p.relative_to(bench).parts]
    bad = []
    for path, names in walk(files, roots).items():
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(root)} imports {name}")
    ref = sorted((bench / "reference").rglob("*.py"))
    for path, names in walk(ref, roots).items():
        for name in names:
            if name.split(".")[0] == "repro_torch":
                bad.append(f"the reference reaches {name} through {path.relative_to(root)}")
    return bad
