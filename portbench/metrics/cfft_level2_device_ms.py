"""Device ms a call of the ops launched inside the launch spans of the
complex composite's level 2, K6 ``l2`` and ``l2_rev`` (the four-step
twiddle and length-C column FFTs, and their inverse), in the host-ops
window (``portbench/spans.py``). ``None`` where the program has neither
span."""

from portbench import spans

SPANS = (spans.LAUNCH + "composite_l2_kernel", spans.LAUNCH + "composite_l2_rev_kernel")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
