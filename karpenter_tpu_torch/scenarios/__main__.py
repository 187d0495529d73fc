"""The scenario-flywheel soak from the command line: replay a composed
trace against the full reactive Operator under accelerated injected
time and exit with the judge's verdict, byte-identical across runs of
the same spec and seed.

    python -m karpenter_tpu_torch.scenarios [--spec smoke|flywheel] \
        [--seed N] [--duration SECONDS] [--faults EXTRA_FAULT_ENTRIES] \
        [--out report.json] [--device cuda|cpu]

The flywheel mode of the JAX package's `tools/soak.py`, with `--device`
(default: the card; `cpu` runs the kernels' plain versions). Exit code 0
when the judge passes, 1 when any observability plane fails (the report
names the failing planes), 2 on usage errors and when the card is asked
for and there is none. `--faults` appends raw KARPENTER_FAULTS entries
to the composed spec (e.g. `exec_delay@crash_tick:*=2s#lag` burns the
tick-latency SLO and must flip the verdict to FAIL).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.scenarios",
        description="deterministic scenario-flywheel soak")
    parser.add_argument("--spec", choices=("smoke", "flywheel"), default="flywheel",
                        help="scenario preset (default: flywheel)")
    parser.add_argument("--seed", type=int, default=None,
                        help="override the preset's seed")
    parser.add_argument("--duration", type=float, default=None,
                        help="override the trace horizon, virtual seconds")
    parser.add_argument("--faults", default=None,
                        help="extra KARPENTER_FAULTS entries appended to "
                             "the composed spec (comma-separated)")
    parser.add_argument("--out", default=None,
                        help="write the full verdict artifact here (JSON)")
    parser.add_argument("--device", default="cuda",
                        help="device of every solve (default: cuda, the card)")
    args = parser.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # no card and no --device cpu: an error, never a move to the CPU
        print(f"no CUDA device is available for --device {args.device}; pass "
              "--device cpu to run the plain versions of the kernels", file=sys.stderr)
        return 2

    from karpenter_tpu_torch.scenarios import flywheel_spec, run_soak, smoke_spec

    preset = smoke_spec if args.spec == "smoke" else flywheel_spec
    kwargs = {}
    if args.seed is not None:
        kwargs["seed"] = args.seed
    if args.duration is not None:
        kwargs["duration_s"] = args.duration
    spec = preset(**kwargs)
    if args.faults:
        extra = tuple(e.strip() for e in args.faults.split(",") if e.strip())
        spec = dataclasses.replace(spec, name=spec.name + "_injected",
                                   faults=spec.faults + extra)

    report = run_soak(spec, device=device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
    planes = report["planes"]
    print(f"scenario={report['scenario']} seed={report['seed']} "
          f"digest={report['report_digest'][:16]} "
          f"{'PASS' if report['pass'] else 'FAIL'}")
    for name in sorted(planes):
        print(f"  {name}: {'pass' if planes[name]['pass'] else 'FAIL'}")
    if not report["pass"]:
        print("failing planes:", ", ".join(report["failures"]))
        slo = planes["slo"]
        if slo["budget_exhausted"]:
            print("  slo budget exhausted:", ", ".join(slo["budget_exhausted"]),
                  "burn:", slo["whole_run_burn"])
        if planes["leaks"]["leaks"]:
            print("  leaks:", "; ".join(planes["leaks"]["leaks"]))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
