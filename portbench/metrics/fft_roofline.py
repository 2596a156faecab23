"""The transforms' share of their roofline: the least time of a forward
and an inverse real FFT on the call's rows (``roofline.roundtrip_work``)
over the device's busy time a call. In a cell where only the transforms
run, any kernels that implement them are judged on the same work."""

from portbench import roofline


def read(r):
    work = r.work.get("fft")
    if work is None or r.busy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / (r.busy_s / r.calls)
