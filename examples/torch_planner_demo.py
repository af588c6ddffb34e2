"""The paper's configuration guidelines, automated, on the PyTorch port (the
twin of ``examples/planner_demo.py``): for every assigned architecture x
input shape, print the planner's recommendation (microbatch = X_mini,
attention algorithm, remat, FSDP, optimizer, Lemma-3.2 sync schedule, fit
verdict) on the port's clusters: ``single`` is one 8 x H100 SXM node,
``multi`` two of them (``repro_torch.api.session.MESH_CLUSTERS``).

    PYTHONPATH=src python examples/torch_planner_demo.py \\
        [--mesh single|multi] [--device cuda|cpu]

The planner is host arithmetic; ``--device`` names the card the plans are
for, and ``cuda`` without a card raises, as every entry point of the port.
"""
import argparse

from repro_torch.api.session import MESH_CLUSTERS
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core.hardware import MeshSpec, get_cluster
from repro_torch.core.planner import plan
from repro_torch.models.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    mesh = MeshSpec.from_cluster(get_cluster(MESH_CLUSTERS[args.mesh]))

    hdr = (f"{'arch':24s} {'shape':12s} {'mb':>3s} {'attn':8s} {'remat':6s} "
           f"{'fsdp':5s} {'opt':9s} {'mem(GB)':>8s} {'fit':3s} "
           f"{'t_est(s)':>9s}")
    print(f"mesh: dp={mesh.dp} tp={mesh.tp} ({mesh.chips} x "
          f"{mesh.chip.name})")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            p = plan(cfg, get_shape(shape_name), mesh)
            rows.append((arch, shape_name, p))
            print(f"{arch:24s} {shape_name:12s} {p.microbatch:3d} "
                  f"{p.attn_impl:8s} {p.remat:6s} {str(p.fsdp):5s} "
                  f"{p.opt_kind:9s} {p.est_memory_gb:8.2f} "
                  f"{'Y' if p.fits else 'N':3s} {p.est_step_time:9.3f}")
            for note in p.notes:
                print(f"{'':24s} - {note}")
    return mesh, rows


if __name__ == "__main__":
    main()
