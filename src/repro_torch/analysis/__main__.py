"""CLI: ``python -m repro_torch.analysis [--all|--ranges|--fs|--tape|--locks|
--mutants] [--device cuda|cpu]`` (mirrors ``python -m repro.analysis``).

The device defaults to ``cuda`` and raises without a card; ``--device cpu``
runs every kernel's plain version instead (and skips part (c) of
``ranges``, which holds the kernels against them on the card).  Exit
status 0 iff every requested analysis reports zero findings and, with
``--mutants``, every seeded bug is detected.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.device import resolve_device

from . import ALL_ANALYSES, AnalysisError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="NANOZK soundness static analysis of the PyTorch port")
    ap.add_argument("--all", action="store_true",
                    help="run ranges + fs + tape + locks")
    for name in ALL_ANALYSES:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"run the {name} analysis")
    ap.add_argument("--mutants", action="store_true",
                    help="run the seeded-bug corpus (each must be caught)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the golden proves and kernels run")
    args = ap.parse_args(argv)

    selected = [n for n in ALL_ANALYSES if getattr(args, n)]
    if args.all:
        selected = list(ALL_ANALYSES)
    if not selected and not args.mutants:
        ap.error("nothing selected — pass --all, --mutants, or a pass name")
    dev = resolve_device(args.device)

    failed = False
    # fs and tape share one golden prove; build the log once
    log = None
    if {"fs", "tape"} & set(selected):
        from .replay import run_golden_prove
        print(f"[analysis] recording golden prove on {dev} ...", flush=True)
        t0 = time.time()
        log = run_golden_prove(device=dev)
        print(f"[analysis] golden prove: {len(log.events)} events "
              f"in {time.time() - t0:.1f}s")

    for name in selected:
        t0 = time.time()
        try:
            if name == "fs":
                from . import fs_lint
                findings = fs_lint.run(log)
            elif name == "tape":
                from . import tape_lint
                findings = tape_lint.run(log)
            else:
                findings = ALL_ANALYSES[name](dev)
        except AnalysisError as e:
            print(f"[analysis] {name}: ANALYZER ERROR: {e}")
            failed = True
            continue
        dt = time.time() - t0
        print(f"[analysis] {name}: {len(findings)} finding(s) in {dt:.1f}s")
        for f in findings:
            print(f"  {f}")
        failed |= bool(findings)

    if args.mutants:
        from .mutants import run_corpus
        print("[analysis] running mutation corpus ...", flush=True)
        for r in run_corpus(device=dev):
            status = "caught" if r.detected else "MISSED"
            extra = f" (prove: {r.prove_error})" if r.prove_error else ""
            print(f"[mutants] {r.name} [{r.analysis}]: {status} "
                  f"({len(r.findings)} finding(s)){extra}")
            if not r.detected:
                for f in r.findings[:10]:
                    print(f"  {f}")
                failed = True

    print(f"[analysis] {'FAIL' if failed else 'OK'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
