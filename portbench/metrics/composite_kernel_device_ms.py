"""Device ms a call of the ops launched inside the launch spans of the
two-level composite's kernels (K6 in its four roles, K7a, K7b:
``COLUMNS``) and of K4 (``cfft_kernel``, the DC and Nyquist line
transforms), in the host-ops window (``portbench/spans.py``). ``None``
where the program has none of these spans."""

from portbench import spans

COLUMNS = tuple(spans.LAUNCH + k for k in ("composite_l1_kernel", "composite_l2_kernel", "composite_l2_rev_kernel",
                                           "composite_l1_rev_kernel", "rfft_cols_kernel", "irfft_cols_kernel"))
SPANS = (*COLUMNS, spans.LAUNCH + "cfft_kernel")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
