"""§Roofline on the port: per (arch × shape) on the single-pod mesh, the
three roofline terms from the port's dry-run records (the twin of
``benchmarks/roofline.py``), priced on the H100 SXM
(``core/hardware.py::H100_SXM``):

  compute    = FLOPs / 989e12 FLOP/s       (per-chip, from the meta trace)
  memory     = bytes / 3.35e12 B/s         (unfused upper bound: eager)
  collective = wire_bytes / link_bw        (per-chip, launch/wire.py)

``link_bw`` is NVLink's 450e9 B/s while the ``model`` axis fits in one
8-card node, and ``H100_IB_BW`` (50e9 B/s a card) beyond that: the
production mesh's 16-way ``model`` axis spans two nodes.  Plus
MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (prefill, decode) and
the useful-compute ratio MODEL_FLOPS / (FLOPs × chips), and whether the
per-chip bytes fit the card's 80e9.  Writes
``results/torch_roofline.md``.

    PYTHONPATH=src python benchmarks/torch_roofline.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core.hardware import H100_IB_BW, H100_SXM  # noqa: E402

HBM_BUDGET = H100_SXM.hbm_bytes
NODE = 8  # cards on one NVLink node
INDIR = "results/torch_dryrun"


def model_flops(cfg, shape) -> float:
    n_act = mm.n_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # decode: one token per example


def link_bw(rec) -> float:
    """NVLink while the ``model`` axis stays inside one node, else the
    node's InfiniBand rate per card."""
    tp = (rec.get("mesh_shape") or [0])[-1]
    return H100_SXM.link_bw if 0 < tp <= NODE else H100_IB_BW


def suggestion(dominant: str, cfg, shape) -> str:
    if dominant == "collective":
        if shape.kind == "train":
            return ("keep the model axis inside one NVLink node (32x8) / "
                    "land gradients by reduce-scatter (--opt)")
        return "shard params less (no FSDP at decode) / cache layout"
    if dominant == "memory":
        if shape.kind == "decode":
            return "int8 KV cache (--opt) / ring-buffer SWA slots"
        return "fuse the eager ops (norms, casts, softmax) to cut traffic"
    return ("compute-bound: tensor-core tile multiples (64/128) on every "
            "matmul; already healthy")


def load_record(arch: str, shape: str, mesh: str = "single", indir=INDIR):
    p = Path(indir) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def run(csv_rows, write_md: bool = True, indir=INDIR, outdir="results"):
    print("\n== Roofline on the H100 SXM (single-pod mesh, 256 ranks, "
          "per-chip terms in seconds) ==")
    hdr = (f"{'arch':24s} {'shape':12s} {'var':7s} {'compute':>9s} "
           f"{'memory':>9s} {'coll':>9s} {'dominant':>9s} {'useful':>7s} "
           f"{'mem/chip':>9s} {'fit':>4s}")
    print(hdr)
    lines = ["# Roofline — the port's dry runs on the single-pod mesh "
             "(16×16, 256 ranks), priced on the H100 SXM (989e12 FLOP/s "
             "bf16, 3.35e12 B/s HBM, 80e9 B; NVLink 450e9 B/s while the "
             "model axis fits in an 8-card node, else 50e9 B/s InfiniBand)",
             "",
             "| arch | shape | variant | compute s | memory s | collective s |"
             " dominant | MODEL/FLOPs | bytes/chip GiB | fits 80 GB | "
             "next lever |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in ARCH_IDS:
        cfg0 = get_config(arch)
        for shape_name, shape in SHAPES.items():
            rec = load_record(arch, shape_name, indir=indir)
            if rec is None:
                continue
            if not rec.get("ok"):
                lines.append(f"| {arch} | {shape_name} | - | FAILED: "
                             f"{rec.get('error', '?')[:60]} | | | | | | | |")
                continue
            d = rec["derived"]
            t_comp = d["flops"] / H100_SXM.peak_flops
            t_mem = d["bytes_accessed"] / H100_SXM.hbm_bw
            t_coll = d["wire_bytes"] / link_bw(rec)
            terms = {"compute": t_comp, "memory": t_mem,
                     "collective": t_coll}
            dom = max(terms, key=terms.get)
            mf = model_flops(cfg0, shape)
            useful = mf / max(d["flops"] * rec["num_devices"], 1.0)
            memo = rec.get("full", {}).get("memory", {})
            per_chip = (memo.get("argument_bytes", 0)
                        + memo.get("temp_bytes", 0)
                        + memo.get("output_bytes", 0))
            fits = per_chip <= HBM_BUDGET
            var = rec.get("variant", "native")[:7]
            print(f"{arch:24s} {shape_name:12s} {var:7s} {t_comp:9.3f} "
                  f"{t_mem:9.3f} {t_coll:9.3f} {dom:>9s} {useful:7.2f} "
                  f"{per_chip/2**30:9.2f} {'Y' if fits else 'N':>4s}")
            lines.append(
                f"| {arch} | {shape_name} | {rec.get('variant', 'native')} | "
                f"{t_comp:.3f} | {t_mem:.3f} | {t_coll:.3f} | **{dom}** | "
                f"{useful:.2f} | {per_chip/2**30:.2f} | "
                f"{'yes' if fits else 'NO'} | "
                f"{suggestion(dom, cfg0, shape)} |")
            csv_rows.append((f"roofline/{arch}/{shape_name}/{dom}",
                             terms[dom], f"useful={useful:.2f}"))
    if write_md:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "torch_roofline.md").write_text("\n".join(lines) + "\n")
        print(f"wrote {out / 'torch_roofline.md'}")
    return lines


if __name__ == "__main__":
    run([])
