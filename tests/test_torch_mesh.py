"""The port's mesh description, sharding rules, dry-run knobs, wire model
and mesh-axis analyzer against the JAX package, on the CPU.

JAX's ``sharding_rules`` and ``dp_axes`` read only ``mesh.shape`` and
``mesh.axis_names``, so they run here on a duck-typed mesh; its
``variant_config``, ``_reduced_cycles``, ``_planner_defaults``,
``hlo.collective_bytes`` (on hand-written HLO lines) and
``roofline.model_flops`` run in-process too.  ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when imported; jax is initialised first and the variable
restored, so this process keeps its device count.
"""
import dataclasses
import importlib.util
import os
import re
import sys
import types
from pathlib import Path
from textwrap import dedent

import jax
import pytest

from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.launch import hlo as jhlo
from repro.launch import mesh as jmesh
from repro_torch.analysis import mesh_axes
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import wire

REPO = Path(__file__).resolve().parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}


def _jax_dryrun():
    jax.devices()  # lock this process's device count before the import
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdry


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _duck(dims, names):
    return types.SimpleNamespace(shape=dict(zip(names, dims)),
                                 axis_names=names)


def test_catalogue_matches():
    assert list(ARCH_IDS) == list(JARCH_IDS)
    assert list(SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_rules_equal_jax(arch, mesh_kind):
    dims, names = MESHES[mesh_kind]
    mesh = tmesh.Mesh(dims, names)
    duck = _duck(dims, names)
    assert tmesh.dp_axes(mesh) == jmesh.dp_axes(duck)
    for shape in [None] + list(SHAPES):
        for fsdp in (False, True):
            got = tmesh.sharding_rules(
                mesh, get_config(arch), SHAPES[shape] if shape else None,
                fsdp=fsdp)
            want = jmesh.sharding_rules(
                duck, jget_config(arch), JSHAPES[shape] if shape else None,
                fsdp=fsdp)
            assert got == want, (arch, shape, mesh_kind, fsdp)


def test_production_mesh_and_specs():
    single, multi = (tmesh.make_production_mesh(),
                     tmesh.make_production_mesh(multi_pod=True))
    assert (single.dims, single.axis_names) == MESHES["single"]
    assert (multi.dims, multi.axis_names) == MESHES["multi"]
    assert multi.size == 512
    # JAX's act_sharding / batch_sharding specs, as partition tuples
    assert tmesh.act_spec(single) == (("data",), "model", None)
    assert tmesh.act_spec(multi, SHAPES["long_500k"]) == (None, "model", None)
    assert tmesh.act_spec(single, seq_parallel=False) == (("data",), None,
                                                          None)
    assert tmesh.batch_spec(multi, SHAPES["train_4k"]) == (("pod", "data"),)
    # ranks row-major over the axes; a group's members in index order
    m = tmesh.Mesh((2, 3, 4), ("pod", "data", "model"))
    assert m.coords(17) == {"pod": 1, "data": 1, "model": 1}
    assert m.axis_index(("pod", "data"), 17) == 4
    assert m.group_ranks("model", 17) == (16, 17, 18, 19)
    assert m.group_ranks(("pod", "data"), 17) == (1, 5, 9, 13, 17, 21)
    assert tmesh.group_keys(m) == (("pod",), ("data",), ("model",),
                                   ("pod", "data"),
                                   ("pod", "data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_knobs_equal_jax(arch):
    jdry = _jax_dryrun()
    jrf = _load("benchmarks/roofline.py")
    trf = _load("benchmarks/torch_roofline.py")
    for shape in SHAPES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        fsdp, opt = D._planner_defaults(cfg, SHAPES[shape])
        jfsdp, jopt = jdry._planner_defaults(jcfg, JSHAPES[shape])
        assert (fsdp, dataclasses.asdict(opt)) == \
            (jfsdp, dataclasses.asdict(jopt))
        (v, name), (jv, jname) = (D.variant_config(cfg, SHAPES[shape]),
                                  jdry.variant_config(jcfg, JSHAPES[shape]))
        assert name == jname
        # the port's one field that JAX's lacks holds every expert here
        tv = dataclasses.asdict(v)
        assert tv.pop("experts_held") == 0
        assert tv == dataclasses.asdict(jv)
        for n in (1, 2):
            assert D._reduced_cycles(v, n).num_layers == \
                jdry._reduced_cycles(jv, n).num_layers
        assert trf.model_flops(cfg, SHAPES[shape]) == \
            jrf.model_flops(jcfg, JSHAPES[shape])


def _hlo(op: str, n: int) -> tuple:
    """A two-line HLO module with one ``op`` over ``n`` ranks and the
    record the port's group logs for the same call."""
    groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
    elems = 256 * n
    if op == "all-gather":
        res, opd = elems * n, elems
    elif op == "reduce-scatter":
        res, opd = elems // n, elems
    else:
        res = opd = elems
    tail = ("source_target_pairs={{0,1}}" if op == "collective-permute"
            else f"replica_groups={groups}")
    text = dedent(f"""\
        %p0 = f32[{opd}]{{0}} parameter(0)
        %c = f32[{res}]{{0}} {op}(f32[{opd}]{{0}} %p0), {tail}
        """)
    rec = {"op": op, "operand_bytes": 4 * opd, "result_bytes": 4 * res,
           "group": 2 if op == "collective-permute" else n}
    return text, rec


@pytest.mark.parametrize("n", (2, 4, 16))
@pytest.mark.parametrize("op", wire.COLLECTIVES)
def test_wire_model_equals_hlo(op, n):
    assert wire.COLLECTIVES == jhlo.COLLECTIVES
    text, rec = _hlo(op, n)
    want = jhlo.collective_bytes(text)
    got = wire.collective_bytes([rec, rec])
    assert set(got) == set(want) == {op}
    for k, v in want[op].items():
        assert got[op][k] == pytest.approx(2 * v, rel=0, abs=0), k
    assert wire.total_wire_bytes(got) == 2 * jhlo.total_wire_bytes(want)


# ---------------------------------------------------------------------------
# mesh_axes (MX1xx), mirroring tests/test_analysis.py on torch sources
# ---------------------------------------------------------------------------

MX_DECL = dedent("""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 4), ("nodes", "data"))
""")

MX_BAD = dedent("""
    from repro_torch.launch.mesh import groups

    def sync(mesh, g):
        return groups(mesh, 0)["model"].all_reduce(g)  # never declared
""")

MX_MISSING = dedent("""
    import torch.distributed as dist

    def sync(g):
        dist.all_reduce(g)  # no group: the whole world
        return g
""")

MX_GOOD = dedent("""
    import torch.distributed as dist

    def sync(ctx, g, pg):
        ctx.group(("nodes", "data")).all_reduce(g)
        dist.all_reduce(g, group=pg)
        return g
""")


def test_mx101_unbound_axis():
    found = mesh_axes.analyze_sources(
        [("src/repro_torch/mesh.py", MX_DECL),
         ("src/repro_torch/bad.py", MX_BAD)])
    assert [f.code for f in found] == ["MX101"]


def test_mx101_keywords_and_lookups():
    src = dedent("""
        def f(x, ctx, cfg, moe_mlp_sharded, get_group):
            get_group("pipe")
            ctx.group("tensor")
            return moe_mlp_sharded(x, cfg, mesh=ctx, axis="experts",
                                   moe_axis="data")
    """)
    found = mesh_axes.analyze_sources(
        [("src/repro_torch/mesh.py", MX_DECL),
         ("src/repro_torch/f.py", src)])
    assert sorted(re.search(r"axis '(\w+)'", f.message).group(1)
                  for f in found) == ["experts", "pipe", "tensor"]


def test_mx102_missing_group():
    found = mesh_axes.analyze_sources(
        [("src/repro_torch/bad.py", MX_MISSING)])
    assert [f.code for f in found] == ["MX102"]
    src = "from torch.distributed import barrier as b\nb()\n"
    assert [f.code for f in mesh_axes.analyze_sources(
        [("src/repro_torch/b.py", src)])] == ["MX102"]


def test_mx_bound_axes_are_clean():
    assert mesh_axes.analyze_sources(
        [("src/repro_torch/mesh.py", MX_DECL),
         ("src/repro_torch/ok.py", MX_GOOD)]) == []


def test_mx_variable_axis_is_skipped():
    src = dedent("""
        def sync(ctx, g, axis):
            return ctx.group(axis).all_reduce(g)
    """)
    assert mesh_axes.analyze_sources([("src/repro_torch/var.py", src)]) == []


def test_mx_port_declares_its_axes_and_is_clean():
    axes = set()
    for p in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        axes |= mesh_axes.declared_axes(
            p.read_text(), p.relative_to(REPO).as_posix())
    assert {"pod", "data", "model"} <= axes, sorted(axes)
    assert mesh_axes.analyze(REPO) == []
    sys.path.insert(0, str(REPO / "tools"))
    try:
        lint = _load("tools/torch_lint.py")
        assert lint.main(["--analyzer", "mesh"]) == 0
    finally:
        sys.path.remove(str(REPO / "tools"))


def test_groups_under_an_initialised_world():
    """Without a store, ``groups`` makes every group of the mesh with
    ``dist.new_group`` (torchrun's path); a one-rank world here."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = tmesh.Mesh((1, 1), ("data", "model"))
        gr = tmesh.groups(mesh, 0, device="cpu")
        assert set(gr) == set(tmesh.group_keys(mesh))
        assert all(g.size == 1 and g.rank == 0 for g in gr.values())
    finally:
        dist.destroy_process_group()
