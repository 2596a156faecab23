"""``cpu_cell`` with two more planted faults, in the complex round trip:
level 2 of the complex composite given the conjugate four-step twiddle
(both ways, so the round trip still closes and only the spectrum is
wrong), and one row of ``api.fft``'s spectrum zeroed where it is
produced.

    python -m portbench.tests.cfft_cpu_cell WORKLOAD SEED SECONDS [--control] [--fault NAME] [--trace]
"""

from __future__ import annotations

from chowdsp_fft_tpu_torch import api
from chowdsp_fft_tpu_torch.ops import hopper_composite

from portbench.tests import cpu_cell


def conjugated_twiddle(patch=setattr):
    """Level 2 given the conjugate four-step twiddle, set by ``patch``
    (pytest's ``monkeypatch.setattr`` in a test)."""
    twiddle = hopper_composite.twiddle
    patch(hopper_composite, "twiddle", lambda n, forward, device: twiddle(n, not forward, device))


def zeroed_row(patch=setattr):
    """``api.fft`` with row 0 of its spectrum zeroed, set by ``patch``."""
    fft = api.fft

    def zeroed(x, plan=None, engine="auto"):
        spec = fft(x, plan=plan, engine=engine).clone()
        spec[0] = 0
        return spec

    patch(api, "fft", zeroed)


cpu_cell.FAULTS["conjugated_twiddle"] = conjugated_twiddle
cpu_cell.FAULTS["zeroed_row"] = zeroed_row

if __name__ == "__main__":
    cpu_cell.main()
