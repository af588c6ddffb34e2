"""End-to-end driver on the PyTorch port (the twin of
``examples/train_100m.py``): train a ~100M-parameter decoder for a few
hundred steps through the ``repro_torch.api`` facade, reporting the
paper's quantities (R_O, Lemma-3.1 efficiency projection, Lemma-3.2
sizing) straight from the unified Report.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \\
        [--arch granite-3-2b] [--device cuda|cpu]

``--device`` is the card unless the caller asks for the CPU; ``cuda``
without a card raises.
"""
import argparse

import numpy as np

from repro_torch.api import JobSpec, Session
from repro_torch.configs.base import get_config
from repro_torch.core import ps
from repro_torch.core.memory_model import n_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ~100M-param member of the chosen family: 16L d=640 ff=2560 V=4096
    cfg = get_config(args.arch).reduced().replace(
        d_model=640, num_heads=8, num_kv_heads=2, head_dim=80, d_ff=2560,
        vocab_size=4096,
    )
    cfg = cfg.replace(num_layers=16 - 16 % len(cfg.pattern))
    print(f"== {cfg.name} ~{n_params(cfg)/1e6:.0f}M params, "
          f"{cfg.num_layers}L d={cfg.d_model} V={cfg.padded_vocab}")

    spec = JobSpec(arch=args.arch, reduced=True, steps=args.steps,
                   batch=args.batch, seq=args.seq, lr=3e-3, log_every=20,
                   ckpt_dir="results/torch_train_100m_ckpt", ckpt_every=100)
    rep = Session(spec, config=cfg, device=args.device).train()

    m = rep.measured
    print(f"\nloss {np.mean(m['losses'][:10]):.3f} -> "
          f"{np.mean(m['losses'][-10:]):.3f}")
    print(f"throughput {m['tokens_per_s']:,.0f} tok/s")

    print("\n== paper quantities from the unified Report ==")
    print(f"R_O (pipelined) = {m['r_o']:.4f}")
    lemma31 = rep.predicted["lemma31"]
    for g, v in lemma31["per_device"].items():
        print(f"  Lemma 3.1: G={int(g):3d} -> efficiency "
              f"{v['efficiency']:.3f}, speedup {v['speedup']:.2f}x")
    t_c = m["step_times_mean"]["compute"]
    s_p = 4.0 * n_params(cfg)
    n_ps = ps.n_parameter_servers(s_p, n_w=8, b_ps=10e9 / 8, t_c=t_c)
    print(f"  Lemma 3.2: S_p={s_p/1e6:.0f} MB, 8 workers, 10 Gbit -> "
          f"N_ps={n_ps}")
    print(f"report -> {rep.save('results/torch_train_100m_report.json')}")
    return rep


if __name__ == "__main__":
    main()
