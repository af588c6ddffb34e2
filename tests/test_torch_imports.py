"""Import guard: the port (``src/repro_torch``), its benchmarks
(``benchmarks/torch_*.py``), its tools (``tools/torch_*.py``), its
examples (``examples/torch_*.py``), the tests that hold it to nothing of
JAX's (``PORT_TESTS``) and ``chip_smoke.py`` import neither
JAX (nor ``ml_dtypes``, which the card's machine lacks) nor anything of
the JAX package ``repro``; they keep their own copies of what they need.
A static AST scan, so it also covers imports inside functions.  Each
example, its ``--device`` left at the default, raises without a card."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BENCHMARKS = sorted((REPO / "benchmarks").glob("torch_*.py"))
TOOLS = sorted((REPO / "tools").glob("torch_*.py"))
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
# the port's own tests that hold it to nothing of JAX's
PORT_TESTS = [REPO / "tests" / "test_torch_trace_spans.py"]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + BENCHMARKS + \
    TOOLS + EXAMPLES + PORT_TESTS + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = [f"{path.relative_to(REPO)}:{line}: {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, "\n".join(bad)


def test_scan_sees_every_module():
    assert len(FILES) > 20 and (REPO / "chip_smoke.py").exists()
    assert len(BENCHMARKS) >= 10 and all(p in FILES for p in BENCHMARKS)
    assert TOOLS and all(p in FILES for p in TOOLS)
    assert [p.name for p in EXAMPLES] == [
        f"torch_{n}.py" for n in ("autotune_quickstart", "planner_demo",
                                  "quickstart", "serve_batch", "train_100m")]
    for new in ("src/repro_torch/distributed/pipeline.py",
                "src/repro_torch/core/pipeline.py",
                "benchmarks/torch_pipeline.py",
                "benchmarks/torch_run.py", "benchmarks/torch_telemetry.py",
                "benchmarks/torch_serve_continuous.py",
                "benchmarks/torch_ilp_planner.py",
                "tools/torch_bench_trajectory.py",
                "src/repro_torch/analysis/kernel_contracts.py",
                "tools/torch_lint.py",
                "src/repro_torch/distributed/spmd.py",
                "src/repro_torch/distributed/layout.py",
                "src/repro_torch/launch/dryrun.py",
                "src/repro_torch/analysis/mesh_axes.py",
                "benchmarks/torch_roofline.py",
                "src/repro_torch/models/spans.py",
                "tests/test_torch_trace_spans.py"):
        assert REPO / new in FILES, new
    assert _forbidden("repro.models") and _forbidden("jax.numpy")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.models")


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_raise_without_a_card(path, monkeypatch, tmp_path):
    """``--device`` defaults to the card: with none visible, ``main()``
    raises before any work, never falling back to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
    assert not (tmp_path / "results").exists()
