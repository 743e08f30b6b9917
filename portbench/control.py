#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the reference's
forward put in the program's place in a lower precision, at a cell's own
sizes, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --queries 6

For each seed it makes the weights and queries a run of that seed makes,
answers each query with the reference's chain forward in a lower
precision (its integer products in that precision), commits the answers'
boundaries as the program would, and judges them with the harness's own
comparison (``check.boundaries``, ``compare``'s part for the boundaries,
and ``check.correct``) against the reference in float64; the weight
commitments involve no product, so the control leaves them out.  ``tf32-native`` is a float32 product with the
card's TF32 allowed.  One JSON line per seed and precision: the
comparison's counts and whether the run would read correct.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
PRECISIONS = ("float32", "tf32", "tf32-native", "bfloat16")


def readings(cell, seed: int, queries: int, precisions, device):
    """{precision: the comparison's counts} over ``queries`` queries of
    one seed, answered in that precision in the program's place."""
    import torch

    from portbench import check, inputs
    from portbench.reference import commit as RC
    from portbench.reference import forward as RF
    tr = cell.traffic
    b = inputs.block(cell.config, tr["seq"])
    wts = inputs.weights(b, cell.config["block"]["layers"], seed, device)
    xs = [inputs.query(b, seed, i, tr["query_std"])
          for i in range(1, queries + 1)]
    out = {}
    for p in precisions:
        served = []
        for x in xs:
            native = p == "tf32-native"
            torch.backends.cuda.matmul.allow_tf32 = native
            acts = RF.chain_forward(b, wts, x, device,
                                    "float32" if native else p)
            torch.backends.cuda.matmul.allow_tf32 = False
            roots = [RC.commit_boundary(h, tr["pcs_blowup"], device)[0]
                     for h in acts]
            served.append(check.Served(query=x, boundary_roots=roots,
                                       stores=[], verified=True))
        out[p] = check.boundaries(b, wts, served, tr["pcs_blowup"], device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--queries", type=int, default=6)
    args = p.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    import torch

    from portbench import check, spec
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load_bench(CHECKOUT), args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.monotonic()
        got = readings(cell, seed, args.queries, PRECISIONS, dev)
        for prec, counts in got.items():
            print(json.dumps(dict(workload=cell.name, seed=seed,
                                  precision=prec, queries=args.queries,
                                  correct=check.correct(counts), **counts,
                                  seconds=time.monotonic() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
