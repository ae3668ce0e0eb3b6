"""Paper reproduction script: tune ResNet-18's convolutions (§3.1-§3.3) —
the port of `examples/tune_resnet18.py`.

Runs genetic search (and optionally RL-search, §2.4) on every deduplicated
convolution group of ResNet-18 and prints the Figure-2b-style speedup table
against the vendor lane (cuDNN through `F.conv2d`, the fitness's
`vendor_time`), plus the Figure-3b search-time column and the §3.3
cache-reuse demonstration.  The fitness is device time on the card
(`WallClockFitness`) unless the caller hands `main` another.

Run:  PYTHONPATH=src python -m repro_torch.examples.tune_resnet18 [--rl] [--device cpu]
"""

import argparse
import time
from typing import Any, Dict

import numpy as np

from repro_torch.core import SearchCache, SearchTask, TEMPLATES, Tuner, WallClockFitness, rl_search
from repro_torch.examples.quickstart import fitness_label
from repro_torch.models.resnet import conv_groups
from repro_torch.platform import resolve_device


def main(argv=None, fitness=None) -> Dict[str, Any]:
    """Tune and print the table; -> {"rows": [(name, shape, vendor s, wpk
    s, speedup, search s)], "hits": the warm re-tune's cache hits,
    "groups": the number of conv groups, "retune_s"}.  `fitness`: the
    tuner's (None: `WallClockFitness` on the device)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rl", action="store_true", help="also run RL-search (§2.4, slower)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if fitness is None:
        fitness = WallClockFitness(device=device)

    cache = SearchCache()
    tuner = Tuner(methods=("genetic",), cache=cache, fitness=fitness)
    groups = conv_groups(batch=1, image=224)
    print(f"fitness: {fitness_label(fitness, device)}; vendor: cuDNN (F.conv2d)")
    print(f"{'conv':8s} {'shape':>24s} {'vendor us':>10s} {'wpk us':>8s} "
          f"{'speedup':>8s} {'search s':>9s}")
    rows = []
    for name, op in groups:
        t0 = time.perf_counter()
        res = tuner.tune(op)
        dt = time.perf_counter() - t0
        if args.rl:
            rl = rl_search(SearchTask(op, TEMPLATES["pallas_conv2d"], fitness, seed=0),
                           episodes=3, steps_per_episode=16,
                           device=getattr(fitness, "device", None))
            if rl.runtime_s < res.runtime_s:
                res = rl
        t_vendor = fitness.vendor_time(op)
        sp = t_vendor / res.runtime_s
        d = op.d
        shape = f"{d['h']}x{d['w']}x{d['cin']}->{d['cout']} k{d['kh']} s{d['stride']}"
        rows.append((name, shape, t_vendor, res.runtime_s, sp, dt))
        print(f"{name:8s} {shape:>24s} {t_vendor * 1e6:10.2f} "
              f"{res.runtime_s * 1e6:8.2f} {sp:8.2f} {dt:9.2f}")

    speedups = [r[4] for r in rows]
    print(f"\nmean speedup {np.mean(speedups):.2f}x  max {np.max(speedups):.2f}x "
          f"(paper, on a P100: 2.54x mean, 5.40x max over cuDNN)")

    # §3.3: the cache makes a second model from the same backbone ~free
    hits0 = cache.hits
    t0 = time.perf_counter()
    for _, op in groups:
        tuner.tune(op)
    retune = time.perf_counter() - t0
    print(f"warm-cache re-tune of the whole backbone: "
          f"{retune * 1e3:.1f} ms ({cache.hits - hits0} hits)")
    return {"rows": rows, "hits": cache.hits - hits0, "groups": len(groups),
            "retune_s": retune}


if __name__ == "__main__":
    main()
