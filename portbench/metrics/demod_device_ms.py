"""Device ms a call of the ops whose innermost program span is
``stream.demod.fm`` (the FM discriminator), in the host-ops window
(``portbench/spans.py``). ``None`` where the program has no such span."""

from portbench import spans

SPANS = ("stream.demod.fm",)


def read(r):
    w = spans.host_window(r)
    if w is None or not any(s.name in SPANS for s in w.spans):
        return None
    return w.device_ms(SPANS)
