"""Batched serving on the PyTorch port (the twin of
``examples/serve_batch.py``): ragged requests through the BatchScheduler
on a reduced gemma2 (sliding-window + softcap) and a reduced musicgen
(multi-codebook audio decoder).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cuda|cpu]

``--device`` is the card unless the caller asks for the CPU; ``cuda``
without a card raises.
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models.blocks import RunConfig
from repro_torch.serve.engine import BatchScheduler, Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    run = RunConfig(attn_impl="dense", remat="none")

    print("== gemma2 (SWA ring cache) ==")
    cfg = get_config("gemma2-27b").reduced().replace(sliding_window=32)
    eng = Engine(cfg, run, s_max=128, device=args.device)
    sched = BatchScheduler(eng, max_batch=4)
    rids = [sched.submit(rng.integers(0, cfg.vocab_size, (n,))
                         .astype(np.int32), 8)
            for n in (9, 17, 33, 21, 12)]
    out = sched.run()
    for rid in rids:
        print(f"  req {rid}: {out[rid].tolist()}")

    print("== musicgen (4 EnCodec codebooks) ==")
    mcfg = get_config("musicgen-large").reduced()
    meng = Engine(mcfg, run, s_max=64, device=args.device)
    prompts = rng.integers(0, mcfg.vocab_size,
                           (2, 12, mcfg.num_codebooks)).astype(np.int32)
    res = meng.generate(prompts, n_new=6)
    print(f"  generated {res.tokens.shape} codebook tokens "
          f"({res.tokens_per_s:.1f} tok/s)")
    print(f"  frame 0: {res.tokens[0, 0].tolist()}")
    return out, res


if __name__ == "__main__":
    main()
