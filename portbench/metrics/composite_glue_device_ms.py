"""Device ms a call of the ops whose innermost program span is one of
the composites' own (``ops.hopper_composite.rfft_composite``,
``.irfft_composite``, ``.cfft_composite``): their torch glue, the
Hermitian assembly's ``cat``s, ``flip``s, products and the line
transforms' copies, the kernels' launches being in their own spans; in
the host-ops window (``portbench/spans.py``). ``None`` where the program
has no such span."""

from portbench import spans

SPANS = ("ops.hopper_composite.rfft_composite", "ops.hopper_composite.irfft_composite",
         "ops.hopper_composite.cfft_composite")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
