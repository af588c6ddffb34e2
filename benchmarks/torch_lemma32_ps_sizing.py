"""Paper Lemma 3.2 on the port: parameter-server sizing across the archs
(the twin of ``benchmarks/lemma32_ps_sizing.py``; pure arithmetic on the
port's ``core/{memory_model,ps,hardware,planner}.py``, no device).

    PYTHONPATH=src python benchmarks/torch_lemma32_ps_sizing.py

``run(csv_rows)`` first gives the JAX script's rows, number for number:
the N_ps regimes (in-node against cross-node) on the paper-era 2 x 8-GPU
P2 deployment, the PS-count curve against B_ps, and the grad-sync
schedule per TPU topology.  (The JAX script's cross-check against
``results/dryrun`` has no twin: the port has no XLA dry run.)  Then the
same placement and schedule tables on the H100 clusters the port prices
on, ``h100-8`` (one node, NVLink) and ``h100-2x8`` (two nodes over
400 Gb/s InfiniBand a card), with T_C from the step-time model on one
H100 node; those rows are named ``lemma32_h100*``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import ARCH_IDS, get_config, get_shape  # noqa: E402
from repro_torch.core import memory_model as mm, ps  # noqa: E402
from repro_torch.core.hardware import (MULTI_POD, SINGLE_POD, MeshSpec,  # noqa: E402
                                       get_cluster)
from repro_torch.core.planner import estimate_step_time  # noqa: E402


def run_jax_rows(csv_rows, shape):
    """The JAX script's tables and rows."""
    print("\n== Lemma 3.2: N_ps regimes on the tiered cluster "
          "(paper-era 2x8-GPU P2 deployment, N_w=16) ==")
    p2 = get_cluster("p2-2x8")
    print(f"{'arch':24s} {'S_p(GB)':>8s} {'in-node':>8s} {'cross':>6s} "
          f"{'rec':>11s}")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        s_p = 4.0 * mm.n_params(cfg)  # fp32 params, the PS payload
        t_c = estimate_step_time(cfg, shape, SINGLE_POD, "block", 1)["compute"]
        placement = ps.ps_placement_plan(s_p, 16, p2, max(t_c, 1e-3))
        n_in = placement["in_node"]["n_ps"]
        n_x = placement["cross_node"]["n_ps"]
        print(f"{arch:24s} {s_p/2**30:8.1f} {n_in:8d} {n_x:6d} "
              f"{placement['recommended']:>11s}")
        csv_rows.append((f"lemma32/{arch}/nps_in_node", n_in,
                         f"b_ps={placement['in_node']['b_ps']:.2e}"))
        csv_rows.append((f"lemma32/{arch}/nps_cross_node", n_x,
                         f"b_ps={placement['cross_node']['b_ps']:.2e}"))

    print("\n== PS-count curve vs B_ps (granite-3-2b, the two regimes) ==")
    cfg = get_config("granite-3-2b")
    s_p = 4.0 * mm.n_params(cfg)
    t_c = max(estimate_step_time(cfg, shape, SINGLE_POD, "block", 1)["compute"],
              1e-3)
    print(f"{'B_ps':>12s} {'N_ps':>6s}  regime")
    for bw, regime in ((1e9 / 8, "cross-node 1GbE"),
                       (10e9 / 8, "cross-node 10GbE"),
                       (100e9 / 8, "cross-node 100Gb IB"),
                       (10e9, "in-node PCIe3"),
                       (50e9, "in-node ICI/NVLink")):
        n = ps.n_parameter_servers(s_p, 16, bw, t_c)
        print(f"{bw:12.2e} {n:6d}  {regime}")
        csv_rows.append((f"lemma32_curve/{regime.replace(' ', '_')}/nps", n,
                         f"b_ps={bw:.2e}"))

    print("\n== TPU mapping: grad-sync schedule per topology ==")
    _schedule_table(csv_rows, shape, ((SINGLE_POD, "pod"),
                                      (MULTI_POD, "2pod")), "lemma32_tpu")


def _schedule_table(csv_rows, shape, meshes, prefix):
    print(f"{'arch':24s} {'mesh':8s} {'sched':26s} {'comm(s)':>8s} "
          f"{'T_C(s)':>7s} {'masked':>7s} {'bottleneck':>10s}")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for mesh, label in meshes:
            t_c = estimate_step_time(cfg, shape, mesh, "block", 1)["compute"]
            plan = ps.grad_sync_plan(2.0 * mm.n_params(cfg) / mesh.tp,
                                     mesh.cluster.dp_view(mesh.dp, mesh.tp),
                                     t_c=max(t_c, 1e-9))
            print(f"{arch:24s} {label:8s} {plan.schedule:26s} "
                  f"{plan.comm_time:8.3f} {t_c:7.3f} {str(plan.masked):>7s} "
                  f"{plan.bottleneck_tier:>10s}")
            csv_rows.append((f"{prefix}/{arch}/{label}/masked",
                             float(plan.masked),
                             f"{plan.schedule}@{plan.bottleneck_tier}"))


def run_h100_rows(csv_rows, shape):
    """The same placement and schedule tables on the H100 clusters."""
    node = MeshSpec.from_cluster(get_cluster("h100-8"))
    two = MeshSpec.from_cluster(get_cluster("h100-2x8"))
    print("\n== Lemma 3.2 on the H100: N_ps regimes on h100-2x8 (N_w=16; "
          "T_C on one h100-8 node) ==")
    print(f"{'arch':24s} {'S_p(GB)':>8s} {'in-node':>8s} {'cross':>6s} "
          f"{'rec':>11s}")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        s_p = 4.0 * mm.n_params(cfg)
        t_c = estimate_step_time(cfg, shape, node, "block", 1)["compute"]
        placement = ps.ps_placement_plan(s_p, 16, two.cluster, max(t_c, 1e-3))
        n_in = placement["in_node"]["n_ps"]
        n_x = placement["cross_node"]["n_ps"]
        print(f"{arch:24s} {s_p/2**30:8.1f} {n_in:8d} {n_x:6d} "
              f"{placement['recommended']:>11s}")
        csv_rows.append((f"lemma32_h100/{arch}/nps_in_node", n_in,
                         f"b_ps={placement['in_node']['b_ps']:.2e}"))
        csv_rows.append((f"lemma32_h100/{arch}/nps_cross_node", n_x,
                         f"b_ps={placement['cross_node']['b_ps']:.2e}"))
    print("\n== H100 mapping: grad-sync schedule per cluster ==")
    _schedule_table(csv_rows, shape, ((node, "h100-8"), (two, "h100-2x8")),
                    "lemma32_h100_sync")


def run(csv_rows):
    shape = get_shape("train_4k")
    run_jax_rows(csv_rows, shape)
    run_h100_rows(csv_rows, shape)


if __name__ == "__main__":
    run([])
