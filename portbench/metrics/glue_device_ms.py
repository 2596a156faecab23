"""Device ms a call of every op that is not one of the port's kernels
(``portbench/kernels/*.txt``): plain-torch, cuDNN and cuBLAS kernels,
copies and fills."""


def read(r):
    if not r.device:
        return None
    return 1e3 * sum(op.dur for op in r.device if not r.is_port(op.name)) / r.calls
