"""The readings that the limits of ``correct`` are set from: the numbers
compared, for the program on many seeds and for the control (the float64
reference fed TF32 inputs, in the program's place) on a few, each at the
cell's own size and load, in one process:

    python3 -m portbench.calibrate --workload <name> --seeds 12 --control-seeds 3 --seconds 2

Prints one JSON line a run and a summary: the program's largest reading
(the lower one) and the control's smallest (the upper one) of each
number. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys

import torch

from portbench import harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_019)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    readings = {False: {}, True: {}}
    for control, count in ((False, args.seeds), (True, args.control_seeds)):
        for k in range(count):
            seed = args.first_seed + 7919 * k
            result, _ = harness.run_cell(args.workload, seed=seed, seconds=args.seconds, trace_on=False,
                                         control=control, log=lambda line: None)
            values = {name: c["value"] for name, c in result["checks"].items()}
            print(json.dumps({"workload": args.workload, "control": control, "seed": seed, "checks": values}),
                  flush=True)
            for name, v in values.items():
                readings[control].setdefault(name, []).append(v)
            del result
            gc.collect()
            torch.cuda.empty_cache()
    summary = {name: {"lower": max(vals), "upper": min(readings[True].get(name, [float("nan")])),
                      "program": sorted(vals), "control": sorted(readings[True].get(name, []))}
               for name, vals in readings[False].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
