"""Run a JAX-package test file's cases against the port, without copying
or editing it: ``mirror(file)`` reads ``tests/<file>``, points every
import of ``repro`` (``from repro... import``) at ``repro_torch``, leaves
out the test functions named in ``skip`` and the imported names in
``drop`` (what the port leaves out by design), takes each imported name
in ``bind`` from there instead (the port's counterpart under the
reference's name), executes the result as a module and returns its
namespace. A test module takes it over with
``globals().update(mirror(...))``, so pytest collects the same tests and
fixtures under the port."""

from __future__ import annotations

import ast
import pathlib
import sys
import types

__all__ = ["mirror"]


def _to_port(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def mirror(filename: str, *, skip=(), drop=(), bind=None) -> dict:
    bind = bind or {}
    path = pathlib.Path(__file__).with_name(filename)
    tree = ast.parse(path.read_text(), str(path))
    body = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in skip:
            continue
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "repro" or node.module.startswith("repro.")):
            node.module = _to_port(node.module)
            node.names = [a for a in node.names
                          if a.name not in drop and a.name not in bind]
            if not node.names:
                continue
        if isinstance(node, ast.Import) and any(
                a.name == "repro" or a.name.startswith("repro.")
                for a in node.names):
            raise ValueError(f"{filename}: plain 'import repro' is not "
                             f"mirrored")
        body.append(node)
    tree.body = body
    name = f"_torch_mirror_{path.stem}"
    module = types.ModuleType(name)
    module.__file__ = str(path)
    sys.modules[name] = module
    module.__dict__.update(bind)
    exec(compile(tree, str(path), "exec"), module.__dict__)
    return {k: v for k, v in module.__dict__.items()
            if not k.startswith("__")}
