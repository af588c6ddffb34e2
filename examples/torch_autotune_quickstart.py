"""Autotune quickstart on the PyTorch port (the twin of
``examples/autotune_quickstart.py``): close the loop from measurement to
plan.

One JobSpec with ``tune=True``: the Session times the attention
algorithms (the hand-written kernels on the card), measures a few trainer
steps, calibrates the hardware constants, runs the paper's minibatch
procedure (largest batch under Eq. 5's ``m_bound``), and re-plans on the
measured numbers.  The following ``train()`` adopts the tuned knobs, and
a calibrated sweep compares topologies on measured constants.

    PYTHONPATH=src python examples/torch_autotune_quickstart.py \\
        [--device cuda|cpu]

``--device`` is the card unless the caller asks for the CPU; ``cuda``
without a card raises.
"""
import argparse

from repro_torch.api import JobSpec, Session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = JobSpec(arch="granite-3-2b", reduced=True, steps=6, batch=4,
                   seq=32, log_every=0, tune=True,
                   tune_cache="results/torch_calibration_cache.json")
    sess = Session(spec, device=args.device)

    rep = sess.tune()
    t = rep.measured["tuning"]
    print(f"== tuned: minibatch*={t['minibatch']['chosen']} (m_bound), "
          f"attention -> {t['kernels']['flash_attention']['chosen']}")
    r = t["replan"]
    print(f"   step: measured {r['measured_step_s']*1e3:.1f}ms, "
          f"calibrated model {r['est_step_time_calibrated_s']*1e3:.1f}ms, "
          f"datasheet model {r['est_step_time_uncalibrated_s']*1e3:.4g}ms")
    rep.save("results/torch_autotune_tune_report.json")

    print("== training with the tuned knobs")
    trep = sess.train()
    m = trep.measured
    print(f"   loss {m['losses'][0]:.3f} -> {m['losses'][-1]:.3f}; "
          f"{m['tokens_per_s']:,.0f} tok/s")

    print("== calibrated sweep: topologies priced on measured constants")
    camp = Session.sweep(spec.replace(tune=False),
                         {"topology": ["flat8", "2x4"]}, kind="plan",
                         calibration=sess.tuned.calibration,
                         device=args.device)
    for cell in camp.metrics():
        print(f"   {cell['topology']:6s} -> {cell['schedule']:26s} "
              f"{cell['tokens_per_s']:.3g} tok/s (predicted, calibrated)")
    return rep, trep, camp


if __name__ == "__main__":
    main()
