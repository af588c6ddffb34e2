"""§3.1.3 on the port: the X_mini/algorithm ILP of Eq. 6 solved per arch
under M_bound, then the planner's end-to-end pick per arch at
``train_4k`` (the twin of ``benchmarks/ilp_planner.py``; pure arithmetic
on the port's ``core/{ilp,memory_model,planner}.py``, no device).

    PYTHONPATH=src python benchmarks/torch_ilp_planner.py

``run(csv_rows)`` first prints JAX's two tables on its ``SINGLE_POD`` mesh
(256 TPU v5e chips, dp 16 x tp 16), row for row, with JAX's CSV rows
(``ilp/<arch>/choice``, ``planner/<arch>/fits``).  Then the same two
tables priced on one 8 x H100 SXM node (``h100-8``: dp 8, tp 1, 80 GB a
card), the cluster the port runs on, under the rows ``ilp_h100/...`` and
``planner_h100/...``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import ARCH_IDS, get_config, get_shape  # noqa: E402
from repro_torch.core import ilp, memory_model as mm  # noqa: E402
from repro_torch.core.hardware import H100_NODE, SINGLE_POD, MeshSpec  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402


def _layer_choices(cfg, shape, mb: int, mesh):
    """Choices per layer-type: attention {dense, flash} x remat {no, yes}.
    Times are napkin (relative); memory from the transformer model terms,
    sharded over ``mesh.tp``."""
    S = shape.seq_len
    B = mb
    H = max(cfg.num_heads, 1)
    tp = mesh.tp
    heads_shard = tp if (H % tp == 0) else 1
    choices = []
    dense_mem = 2 * B * (H / heads_shard) * S * S * 4 / tp
    flash_mem = 2 * B * (H / heads_shard) * S * 1024 * 4 / tp
    act_save = B * S * cfg.d_model * 2 / tp
    # (name, time-units, memory): dense is ~10% faster (no rescaling pass),
    # remat=no saves the backward recompute (~25% of step) but keeps 4x acts
    for attn_t, attn_m, aname in ((1.0, dense_mem, "dense"),
                                  (1.1, flash_mem, "flash")):
        for remat_t, remat_m, rname in ((1.25, act_save, "remat"),
                                        (1.0, 4 * act_save, "save")):
            choices.append(ilp.Choice(f"{aname}+{rname}", attn_t * remat_t,
                                      attn_m + remat_m))
    return choices


def ilp_table(csv_rows, shape, mesh, prefix: str) -> None:
    hbm = mesh.chip.hbm_bytes
    print(f"{'arch':24s} {'mb':>3s} {'choice':16s} {'mem(GB)':>8s} {'feasible':>8s}")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.has_attention:
            print(f"{arch:24s}   - (attention-free: algorithm axis degenerate,"
                  " ILP selects remat only)")
        # M_bound = HBM minus params/opt/grads (the paper's Eq. 5 analogue)
        static = mm.train_memory(cfg, shape, dp=mesh.dp, tp=mesh.tp,
                                 fsdp=True, microbatch=1, attn_impl="chunked",
                                 remat="block", seq_parallel=True)
        bound = hbm - (static.params + static.grads + static.opt_state)
        mb = 1
        layers = [_layer_choices(cfg, shape, mb, mesh)] * len(cfg.pattern)
        sol = ilp.solve_ilp(layers, bound / max(len(cfg.pattern), 1) *
                            len(cfg.pattern))
        names = {layers[k][sol.choices[k]].name for k in range(len(layers))}
        print(f"{arch:24s} {mb:3d} {'/'.join(sorted(names)):16s} "
              f"{sol.memory/2**30:8.2f} {str(sol.feasible):>8s}")
        csv_rows.append((f"{prefix}/{arch}/choice", float(sol.feasible),
                         "/".join(sorted(names))))


def planner_table(csv_rows, shape, mesh, prefix: str) -> None:
    for arch in ARCH_IDS:
        p = plan(get_config(arch), shape, mesh)
        print(f"{arch:24s} mb={p.microbatch} attn={p.attn_impl} "
              f"remat={p.remat} fsdp={p.fsdp} opt={p.opt_kind} "
              f"fits={p.fits}")
        csv_rows.append((f"{prefix}/{arch}/fits", float(p.fits),
                         f"mb={p.microbatch},{p.attn_impl},{p.remat}"))


def run_jax_rows(csv_rows, shape) -> None:
    """JAX's tables and rows, on its single-pod mesh."""
    print("\n== Eq. 6 ILP: per-layer algorithm choice under M_bound ==")
    ilp_table(csv_rows, shape, SINGLE_POD, "ilp")
    print("\n== end-to-end planner picks (train_4k, single pod) ==")
    planner_table(csv_rows, shape, SINGLE_POD, "planner")


def run_h100_rows(csv_rows, shape) -> None:
    """The same two tables on one 8 x H100 SXM node."""
    node = MeshSpec.from_cluster(H100_NODE)
    print(f"\n== Eq. 6 ILP on {H100_NODE.name} (dp {node.dp} x tp {node.tp}, "
          f"{node.chip.hbm_bytes / 1e9:.0f} GB a card) ==")
    ilp_table(csv_rows, shape, node, "ilp_h100")
    print(f"\n== end-to-end planner picks (train_4k, {H100_NODE.name}) ==")
    planner_table(csv_rows, shape, node, "planner_h100")


def run(csv_rows):
    shape = get_shape("train_4k")
    run_jax_rows(csv_rows, shape)
    run_h100_rows(csv_rows, shape)


if __name__ == "__main__":
    run([])
