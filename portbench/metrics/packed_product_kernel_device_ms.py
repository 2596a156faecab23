"""Device ms a call of the ops launched inside the launch span of the
port's packed spectral product (``ops._cuda.launch.packed_product_kernel``:
``convolve_accumulate_packed`` on the card, the long-IR cell's per-channel
product in one pass), in the host-ops window (``portbench/spans.py``).
``None`` where the program has no such span."""

from portbench import spans

SPANS = ("ops._cuda.launch.packed_product_kernel",)


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
