"""Device ms a call of the channelizer's inverse DFT across the branches:
the ops whose innermost program span is ``api.ifft`` or the launch span
of K5's complex kernel, in the host-ops window (``portbench/spans.py``).
``None`` where the program has no ``api.ifft`` span in the window."""

from portbench import spans

SPANS = ("api.ifft", "ops._cuda.launch.small_cfft_kernel")


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name == "api.ifft" for s in w.spans):
        return None
    return w.device_ms(SPANS)
