"""Device ms a call of the ops launched inside the launch span of the
port's FM discriminator (``ops._cuda.launch.fm_demod_kernel``: the SDR
chain's per-channel demodulator, one pass over the channelizer's output
where it lies), in the host-ops window (``portbench/spans.py``).
``None`` where the program has no such span."""

from portbench import spans

SPANS = ("ops._cuda.launch.fm_demod_kernel",)


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
