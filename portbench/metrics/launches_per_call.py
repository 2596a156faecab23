"""Device operations a call, from the profiler: kernels of the port and
of plain torch alike, copies and fills."""


def read(r):
    if not r.device:
        return None
    return len(r.device) / r.calls
