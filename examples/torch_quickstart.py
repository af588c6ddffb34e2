"""Quickstart on the PyTorch port: the whole public API is one JobSpec (the
twin of ``examples/quickstart.py``).

Plan, train (with checkpoints), and serve a tiny decoder through the
``repro_torch.api`` facade; every call returns the same Report schema.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60] \\
        [--device cuda|cpu]

``--device`` is the card unless the caller asks for the CPU; ``cuda``
without a card raises.
"""
import argparse

from repro_torch.api import JobSpec, Session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = JobSpec(arch="granite-3-2b", reduced=True,  # laptop-sized
                   steps=args.steps, batch=8, seq=64, lr=3e-3,
                   ckpt_dir="results/torch_quickstart_ckpt", ckpt_every=30,
                   s_max=128, n_new=8, requests=2)
    sess = Session(spec, device=args.device)

    print(f"== plan: {sess.resolved_plan.sync_schedule} sync, "
          f"microbatch {sess.resolved_plan.microbatch} (full-size job)")

    print(f"== training reduced {sess.cfg.name}: d={sess.cfg.d_model} "
          f"L={sess.cfg.num_layers} V={sess.cfg.vocab_size}")
    rep = sess.train()
    m = rep.measured
    print(f"loss {m['losses'][0]:.3f} -> {m['losses'][-1]:.3f}; "
          f"{m['tokens_per_s']:,.0f} tok/s; pipeline R_O={m['r_o']:.3f}")
    rep.save("results/torch_quickstart_train_report.json")

    print("== generating")
    srep = sess.serve()
    for r in srep.measured["per_request"]:
        print(f"req {r['rid']}: head={r['head']}")
    print(f"{srep.measured['n_tokens']} tokens in "
          f"{srep.measured['wall_s']*1e3:.0f} ms "
          f"({srep.measured['tokens_per_s']:.1f} tok/s)")
    srep.save("results/torch_quickstart_serve_report.json")
    print("reports: results/torch_quickstart_{train,serve}_report.json "
          "(one schema: spec + plan + measured + predicted)")
    return rep, srep


if __name__ == "__main__":
    main()
