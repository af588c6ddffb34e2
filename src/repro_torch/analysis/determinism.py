"""Determinism and purity analyzer (DT1xx): an AST pass over
``src/repro_torch``, the port's twin of ``repro.analysis.determinism``.

The port's bitwise contracts (threaded ranks against one process per
rank, paged against linear decode, checkpoint atomicity in JAX's format)
hold only if nothing on a measured path consults an unseeded RNG or a
second clock.  Four rules, JAX's with torch's calls added:

- **DT101**: unseeded randomness.  JAX's rules (legacy ``np.random.*``
  global-RNG calls, zero-arg ``np.random.default_rng()`` and
  ``random.Random()``, module-level ``random.*`` draws), plus torch's
  global-RNG draws that pass no ``generator=`` (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, and the in-place ``.uniform_()`` / ``.normal_()``),
  and every ``torch.manual_seed``, which reseeds the process-global RNG
  under every other caller.  Every draw in the port comes from a
  ``torch.Generator`` or a numpy generator built from an explicit seed.
- **DT102**: a wall-clock read anywhere but ``src/repro_torch/obs/
  trace.py``, the one module allowed to own a clock; measured paths read
  time through ``Tracer`` spans or ``repro_torch.obs.trace.monotonic``.
- **DT103**: a host sync inside a function that issues a
  ``torch.distributed`` collective (``all_reduce``, ``all_gather``,
  ``all_gather_into_tensor``, ``reduce_scatter``,
  ``reduce_scatter_tensor``, ``broadcast``, ``all_to_all``, ``send``,
  ``recv``, ``isend``, ``irecv``, ``barrier``), called from
  ``torch.distributed`` or as a method of a group handle (the port's
  ``Group.all_reduce``, a ProcessGroup's ``allreduce``).  The host syncs are
  ``.item()``, ``.tolist()``, ``.cpu()``, ``float()`` of a non-constant,
  ``np.asarray``/``np.array`` and ``torch.cuda.synchronize``: each makes
  the host wait for the device in the very phase the collective schedule
  exists to overlap.
- **DT104**: a non-atomic checkpoint write.  Inside
  ``src/repro_torch/checkpoint/``, a function that persists state
  (``np.savez``/``np.save``, ``json.dump``, ``torch.save``,
  ``.write_text``/``.write_bytes``) must also call ``os.replace``/
  ``os.rename`` (or ``Path.replace``): it wrote a tmp file and renamed it,
  so a crash cannot leave a torn file.

Import aliases are resolved per module (``import torch.distributed as
dist``, ``from time import perf_counter as pc``), so a renamed import
cannot dodge a rule.  The fingerprint context is the dotted qualname of
the enclosing def/class, so baseline entries survive line drift.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

PACKAGE = "src/repro_torch"
# files allowed to read the wall clock directly (repo-relative)
DT102_EXEMPT = {"src/repro_torch/obs/trace.py"}

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
# np.random.<fn> members that construct explicitly-seeded generators
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "SFC64", "MT19937", "BitGenerator"}
RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "paretovariate",
    "triangular", "vonmisesvariate", "weibullvariate", "getrandbits",
    "randbytes", "seed",
}
# torch draws that take the process-global generator unless given one
TORCH_DRAWS = {"torch." + f for f in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial")}
TORCH_INPLACE_DRAWS = {"uniform_", "normal_"}
COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "broadcast",
               "all_to_all", "send", "recv", "isend", "irecv", "barrier"}
# the same collectives as methods of a c10d ProcessGroup (the port issues
# them through its own group handles, ``distributed/collectives.py::Group``)
PG_COLLECTIVES = {"allreduce", "allgather", "_allgather_base",
                  "_reduce_scatter_base", "alltoall", "alltoall_base"}
HOST_SYNC = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
HOST_SYNC_METHODS = {"item", "tolist", "cpu"}
# DT104: the checkpoint subtree where every persistent write must pair with
# an atomic rename in the same function
DT104_PREFIX = "src/repro_torch/checkpoint/"
PERSIST_WRITES = {"numpy.savez", "numpy.savez_compressed", "numpy.save",
                  "json.dump", "torch.save"}
PERSIST_WRITE_METHODS = {"write_text", "write_bytes"}
ATOMIC_RENAMES = {"os.replace", "os.rename"}


class _Scope:
    __slots__ = ("name", "has_collective", "sync_calls", "writes",
                 "has_rename")

    def __init__(self, name: str):
        self.name = name
        self.has_collective = False
        self.sync_calls: List[Tuple[int, str]] = []
        self.writes: List[Tuple[int, str]] = []
        self.has_rename = False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self._ckpt = path.startswith(DT104_PREFIX)
        self.aliases: Dict[str, str] = {}  # local name -> dotted origin
        self.stack: List[str] = []
        self.scopes: List[_Scope] = []
        self.findings: List[Finding] = []
        self._flagged: Set[Tuple[int, int]] = set()

    @property
    def context(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted origin of an expression, following import aliases
        (``dist.all_reduce`` -> ``torch.distributed.all_reduce``); None if
        the root name is not an import."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id)
        if root is None:
            return None
        return ".".join([root] + list(reversed(parts)))

    def _emit(self, node: ast.AST, code: str, msg: str) -> None:
        key = (node.lineno, node.col_offset)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.findings.append(Finding(path=self.path, line=node.lineno,
                                     code=code, message=msg,
                                     context=self.context))

    # -- imports --------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level or not node.module:
            return  # relative imports never reach stdlib clocks
        for a in node.names:
            if a.name != "*":
                self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    # -- scopes ---------------------------------------------------------
    def _enter(self, node, is_func: bool) -> None:
        self.stack.append(node.name)
        if is_func:
            self.scopes.append(_Scope(self.context))
        self.generic_visit(node)
        if is_func:
            sc = self.scopes.pop()
            if sc.has_collective:
                for line, what in sc.sync_calls:
                    self.findings.append(Finding(
                        path=self.path, line=line, code="DT103",
                        message=f"{what} inside a function that issues a "
                                "torch.distributed collective makes the "
                                "host wait for the device in the phase the "
                                "collectives overlap", context=sc.name))
            if sc.writes and not sc.has_rename:
                for line, what in sc.writes:
                    self.findings.append(Finding(
                        path=self.path, line=line, code="DT104",
                        message=f"{what} persists checkpoint state with no "
                                "os.replace/os.rename in the same function; "
                                "write a tmp file and atomically rename it "
                                "so a crash cannot leave a torn file",
                        context=sc.name))
        self.stack.pop()

    def visit_FunctionDef(self, node): self._enter(node, True)
    def visit_AsyncFunctionDef(self, node): self._enter(node, True)
    def visit_ClassDef(self, node): self._enter(node, False)

    # -- rules ----------------------------------------------------------
    def _check_wall_clock(self, node: ast.AST) -> None:
        dotted = self.resolve(node)
        if dotted in WALL_CLOCK and self.path not in DT102_EXEMPT:
            self._emit(node, "DT102",
                       f"wall-clock read {dotted}(); measured paths go "
                       "through repro_torch.obs.trace (Tracer span or "
                       "monotonic())")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check_wall_clock(node)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self._check_wall_clock(node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.resolve(node.func)
        sc = self.scopes[-1] if self.scopes else None
        if dotted:
            self._check_dt101(node, dotted)
            head, _, tail = dotted.rpartition(".")
            if (sc is not None and head == "torch.distributed"
                    and tail in COLLECTIVES):
                sc.has_collective = True
            if dotted in HOST_SYNC and sc is not None:
                sc.sync_calls.append((node.lineno, f"{dotted}()"))
        elif isinstance(node.func, ast.Attribute):
            if (sc is not None
                    and node.func.attr in COLLECTIVES | PG_COLLECTIVES):
                sc.has_collective = True
            if (node.func.attr in TORCH_INPLACE_DRAWS
                    and not _has_generator(node)):
                self._emit(node, "DT101",
                           f".{node.func.attr}() without generator= draws "
                           "from the process-global RNG; pass a seeded "
                           "torch.Generator")
        if sc is not None:
            if (isinstance(node.func, ast.Name) and node.func.id == "float"
                    and node.args
                    and not isinstance(node.args[0], ast.Constant)):
                sc.sync_calls.append((node.lineno, "float()"))
            if (isinstance(node.func, ast.Attribute) and dotted is None
                    and node.func.attr in HOST_SYNC_METHODS
                    and not node.args):
                sc.sync_calls.append((node.lineno, f".{node.func.attr}()"))
            if self._ckpt:
                self._check_dt104(node, dotted, sc)
        self.generic_visit(node)

    def _check_dt104(self, node: ast.Call, dotted: Optional[str],
                     sc: _Scope) -> None:
        if dotted in PERSIST_WRITES:
            sc.writes.append((node.lineno, f"{dotted}()"))
        elif dotted in ATOMIC_RENAMES:
            sc.has_rename = True
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr in PERSIST_WRITE_METHODS:
                sc.writes.append((node.lineno, f".{node.func.attr}()"))
            elif (node.func.attr == "replace" and dotted is None
                    and len(node.args) == 1):
                # Path.replace(target) is the same atomic rename syscall
                sc.has_rename = True

    def _check_dt101(self, node: ast.Call, dotted: str) -> None:
        if dotted in TORCH_DRAWS:
            if not _has_generator(node):
                self._emit(node, "DT101",
                           f"{dotted}() without generator= draws from the "
                           "process-global RNG; pass a seeded "
                           "torch.Generator")
            return
        if dotted == "torch.manual_seed":
            self._emit(node, "DT101",
                       "torch.manual_seed() reseeds the process-global RNG "
                       "under every other caller; seed a torch.Generator")
            return
        if dotted.rpartition(".")[2] in TORCH_INPLACE_DRAWS:
            if not _has_generator(node):
                self._emit(node, "DT101",
                           f"{dotted}() without generator= draws from the "
                           "process-global RNG; pass a seeded "
                           "torch.Generator")
            return
        if dotted == "numpy.random.default_rng":
            if not node.args and not node.keywords:
                self._emit(node, "DT101",
                           "np.random.default_rng() without a seed; pass "
                           "an explicit seed")
            return
        if dotted.startswith("numpy.random."):
            member = dotted.split(".", 2)[2].split(".")[0]
            if member not in NP_RANDOM_OK:
                self._emit(node, "DT101",
                           f"legacy global-RNG call {dotted}(); use "
                           "np.random.default_rng(seed)")
            return
        if dotted == "random.Random":
            if not node.args and not node.keywords:
                self._emit(node, "DT101",
                           "random.Random() without a seed; pass an "
                           "explicit seed")
            return
        if dotted.startswith("random."):
            if dotted.split(".", 1)[1] in RANDOM_MODULE_FNS:
                self._emit(node, "DT101",
                           f"module-level {dotted}() draws from the "
                           "process-global RNG; use a seeded "
                           "random.Random(seed) instance")


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_source(src: str, path: str) -> List[Finding]:
    """Run the determinism rules over one module's source text.  ``path``
    is the repo-relative path the findings (and DT102 exemptions) use."""
    v = _Visitor(path)
    v.visit(ast.parse(src, filename=path))
    return sorted(v.findings)


def analyze(root) -> List[Finding]:
    root = Path(root)
    out: List[Finding] = []
    for p in sorted((root / PACKAGE).rglob("*.py")):
        out.extend(analyze_source(p.read_text(), p.relative_to(root).as_posix()))
    return out
