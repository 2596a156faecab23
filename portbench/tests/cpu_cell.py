"""Drive one cell through the harness on the CPU (the port's plain
versions), skipping the CLI's look for a card, with the timed path
broken underneath when asked:

    python -m portbench.tests.cpu_cell WORKLOAD SEED SECONDS [--control] [--fault NAME] [--trace]

Prints the result object as the last line of standard output. The
faults (``FAULTS``) are planted in the program's entries, where the
outputs are produced."""

from __future__ import annotations

import argparse
import json

import torch

from chowdsp_fft_tpu_torch import api
from chowdsp_fft_tpu_torch.models import MultichannelConvolver

from portbench import harness


def _half_batch():
    """Half of the rows or channels are left out: their outputs stay 0."""
    apply, rfft = MultichannelConvolver.apply, api.rfft_packed

    def half_apply(self, x):
        y = torch.zeros_like(x)
        y[: x.shape[0] // 2] = apply(self, x)[: x.shape[0] // 2]
        return y

    def half_rfft(x, plan=None, engine="auto"):
        re, im = rfft(x, plan=plan, engine=engine)
        re, im = re.clone(), im.clone()
        re[re.shape[0] // 2:] = 0
        im[im.shape[0] // 2:] = 0
        return re, im

    MultichannelConvolver.apply, api.rfft_packed = half_apply, half_rfft


def _altered_answer():
    """One value of every output is negated where it is produced."""
    apply, irfft = MultichannelConvolver.apply, api.irfft_packed

    def negate(y):
        y = y.clone()
        y.view(-1)[y.numel() // 3] *= -1
        return y

    MultichannelConvolver.apply = lambda self, x: negate(apply(self, x))
    api.irfft_packed = lambda re, im, plan=None, engine="auto": negate(irfft(re, im, plan=plan, engine=engine))


FAULTS = {"half_batch": _half_batch, "altered_answer": _altered_answer}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("workload")
    parser.add_argument("seed", type=int)
    parser.add_argument("seconds", type=float)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=sorted(FAULTS))
    parser.add_argument("--trace", action="store_true")
    args = parser.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    result, lines = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds, trace_on=args.trace,
                                     device="cpu", control=args.control, log=lambda line: None)
    print("\n".join(lines))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
