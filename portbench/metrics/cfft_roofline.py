"""The complex round trip's share of its roofline: the least time of
one call's work (``cfft_work.roundtrip_work``: each row read and written
once each way, two complex FFTs of 5 N log2 N) over the device's busy
time a call (the union of its op intervals over the calls)."""

from portbench import roofline


def read(r):
    work = r.work.get("cfft")
    if work is None or r.busy_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / (r.busy_s / r.calls)
