"""Device ms a call of the ops launched inside the launch spans of the
complex composite's level 1, K6 ``l1`` and ``l1_rev`` (length-A column
FFTs that store rows, and their inverse), in the host-ops window
(``portbench/spans.py``). ``None`` where the program has neither span."""

from portbench import spans

SPANS = (spans.LAUNCH + "composite_l1_kernel", spans.LAUNCH + "composite_l1_rev_kernel")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
