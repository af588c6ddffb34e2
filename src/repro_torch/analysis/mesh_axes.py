"""Mesh/collective axis-consistency analyzer (MX1xx): the twin of
``repro.analysis.mesh_axes`` for the port's rank programs.

A group looked up by an axis name no mesh declares fails only when the
step runs, a ``KeyError`` deep in the first layer; a ``torch.distributed``
collective issued with no ``group=`` on a ``(data, model)`` mesh reduces
over the whole world, which is the torch form of JAX's missing axis.
This pass makes both statically checkable:

- Pass 1 collects every axis name the port *declares*: the string
  literals in ``Mesh(...)`` and ``init_device_mesh(...,
  mesh_dim_names=...)`` calls, in ``axis_names=`` keywords, in the
  tuples of ``make_production_mesh`` and in the values of the dicts
  ``sharding_rules`` returns.  The set is repo-global, as JAX's is:
  ``launch/mesh.py`` declares the axes ``distributed/spmd.py`` and the
  models reduce over.
- Pass 2 audits the places an axis name is passed:

  - **MX101**: a *literal* axis name (or tuple member) that no mesh
    declares, passed to ``groups(...)[...]``, a ``.group(...)`` method
    (``ShardContext.group``), ``get_group(...)``, or as ``moe_axis=`` or
    ``axis=``.
  - **MX102**: a ``torch.distributed`` collective (``all_reduce``,
    ``all_gather``, ``reduce_scatter``, ``broadcast``, ``barrier``, ...)
    called with no ``group=``.

Axis names passed as variables are skipped, as in JAX's pass: the rank
program takes its axes from the rules, and resolving dataflow is out of
scope for a lint pass.  The port reduces only through ``Group``, so it
starts clean.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

MESH_CTORS = {"Mesh", "init_device_mesh"}
DECLARING_DEFS = {"make_production_mesh"}
RULES_DEFS = {"sharding_rules"}
GROUP_LOOKUPS = {"group", "get_group"}
AXIS_KEYWORDS = {"axis", "moe_axis"}
DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "reduce", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter",
    "scatter_object_list", "barrier", "monitored_barrier",
}


def _last(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _str_literals(node: ast.AST) -> Iterable[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value


def _literal_axes(node: Optional[ast.AST]) -> List[str]:
    """The axis names of a string or tuple/list-of-strings literal, else
    [] (a variable: skipped)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return []


def declared_axes(src: str, path: str = "<src>") -> Set[str]:
    """Axis names bound by mesh declarations in one module."""
    axes: Set[str] = set()
    tree = ast.parse(src, filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _last(node.func) in MESH_CTORS:
            for a in node.args:
                axes.update(_str_literals(a))
            for kw in node.keywords:
                if kw.arg in ("axis_names", "mesh_dim_names"):
                    axes.update(_str_literals(kw.value))
        elif isinstance(node, ast.keyword) and node.arg == "axis_names":
            axes.update(_str_literals(node.value))
        elif isinstance(node, ast.FunctionDef):
            if node.name in DECLARING_DEFS:
                for n in ast.walk(node):
                    if isinstance(n, (ast.Tuple, ast.List)):
                        axes.update(_literal_axes(n))
            if node.name in RULES_DEFS:
                for n in ast.walk(node):
                    if isinstance(n, ast.Dict):
                        for v in n.values:
                            axes.update(_str_literals(v))
    return axes


def _dist_aliases(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """(names bound to ``torch.distributed``, bare names imported from
    it -> their collective)."""
    mods: Set[str] = set()
    bare: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module == "torch.distributed":
                for a in node.names:
                    if a.name in DIST_COLLECTIVES:
                        bare[a.asname or a.name] = a.name
    return mods, bare


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    return ""


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, axes: Set[str], tree: ast.AST):
        self.path = path
        self.axes = axes
        self.mods, self.bare = _dist_aliases(tree)
        self.stack: List[str] = []
        self.findings: List[Finding] = []

    @property
    def context(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node): self._scoped(node)
    def visit_AsyncFunctionDef(self, node): self._scoped(node)
    def visit_ClassDef(self, node): self._scoped(node)

    def _check(self, node: ast.AST, where: str, axis: Optional[ast.AST]):
        for name in _literal_axes(axis):
            if name not in self.axes:
                self.findings.append(Finding(
                    path=self.path, line=node.lineno, code="MX101",
                    message=f"{where}: axis {name!r} is never declared "
                            f"by any mesh (declared: "
                            f"{sorted(self.axes) or 'none'})",
                    context=self.context))

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.value, ast.Call) and \
                _last(node.value.func) == "groups":
            self._check(node, "groups(...)[]", node.slice)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = _last(node.func)
        if fn in GROUP_LOOKUPS and (fn == "get_group" or isinstance(
                node.func, ast.Attribute)):
            axis = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "axes"), None)
            self._check(node, f"{fn}()", axis)
        for kw in node.keywords:
            if kw.arg in AXIS_KEYWORDS:
                self._check(node, f"{fn or 'call'}({kw.arg}=)", kw.value)
        coll = None
        if isinstance(node.func, ast.Attribute):
            owner = _dotted(node.func.value)
            if node.func.attr in DIST_COLLECTIVES and (
                    owner in self.mods or owner == "torch.distributed"):
                coll = node.func.attr
        elif isinstance(node.func, ast.Name) and node.func.id in self.bare:
            coll = self.bare[node.func.id]
        if coll is not None and not any(kw.arg == "group"
                                        for kw in node.keywords):
            self.findings.append(Finding(
                path=self.path, line=node.lineno, code="MX102",
                message=f"torch.distributed.{coll}() without group=: it "
                        "reduces over the whole world, not a mesh axis",
                context=self.context))
        self.generic_visit(node)


def analyze_sources(pairs: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Two passes over (path, source) modules: the repo-global axis set,
    then every axis lookup and collective against it."""
    axes: Set[str] = set()
    for path, src in pairs:
        axes |= declared_axes(src, path)
    out: List[Finding] = []
    for path, src in pairs:
        tree = ast.parse(src, filename=path)
        v = _Visitor(path, axes, tree)
        v.visit(tree)
        out.extend(v.findings)
    return sorted(out)


def analyze(root) -> List[Finding]:
    root = Path(root)
    pairs = [(p.relative_to(root).as_posix(), p.read_text())
             for p in sorted((root / "src" / "repro_torch").rglob("*.py"))]
    return analyze_sources(pairs)
