#!/usr/bin/env python
"""Dependency-free CI lint for the repo (no flake8/ruff in this image).

Checks, per Python file: line length <= 79 for library code (99 for
tests/tools/benchmarks), no tabs, no trailing whitespace, no unused
top-level imports (ast-based; names referenced anywhere in the module
count as used), and that every file compiles.

    python tools/lint.py           # lint the repo
    python tools/lint.py path...   # lint specific files
"""

from __future__ import annotations

import ast
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_DIRS = ("lorastencil",)
SOFT_DIRS = ("tests", "tools", "benchmarks", "examples")


def py_files():
    for base in LIB_DIRS + SOFT_DIRS:
        root = os.path.join(REPO, base)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("build", "__pycache__")]
            for f in filenames:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
    for f in ("bench.py", "__graft_entry__.py"):
        p = os.path.join(REPO, f)
        if os.path.exists(p):
            yield p


def used_names(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                names.add(n.id)
    return names


def lint_file(path: str) -> list:
    errors = []
    rel = os.path.relpath(path, REPO)
    limit = 79 if rel.split(os.sep)[0] in LIB_DIRS else 99
    with open(path, encoding="utf-8") as f:
        src = f.read()
    for i, line in enumerate(src.splitlines(), 1):
        if len(line) > limit:
            errors.append(f"{rel}:{i}: line too long ({len(line)} > {limit})")
        if "\t" in line:
            errors.append(f"{rel}:{i}: tab character")
        if line != line.rstrip():
            errors.append(f"{rel}:{i}: trailing whitespace")
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return errors + [f"{rel}:{e.lineno}: syntax error: {e.msg}"]
    used = used_names(tree)
    if os.path.basename(path) == "__init__.py":
        return errors  # imports in package inits are re-exports
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                if name not in used:
                    errors.append(
                        f"{rel}:{node.lineno}: unused import '{name}'")
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "*":
                    continue
                name = a.asname or a.name
                if name not in used and "__all__" not in used:
                    errors.append(
                        f"{rel}:{node.lineno}: unused import '{name}'")
    return errors


def main(argv) -> int:
    files = argv or sorted(py_files())
    all_errors = []
    for p in files:
        all_errors.extend(lint_file(p))
    for e in all_errors:
        print(e)
    print(f"lint: {len(list(files))} files, {len(all_errors)} issues")
    return 1 if all_errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
