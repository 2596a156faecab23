"""Multi-device sharding on ``torch.distributed``: meshes, the halo-exchange
streams, the all_to_all distributed FFT (counterpart of
``chowdsp_fft_tpu/parallel``).

Where the JAX package exports ``Mesh``, ``NamedSharding`` and ``P``, this
one exports their torch analogs, ``DeviceMesh``, ``DTensor`` and the
``Shard``/``Replicate`` placements (the mapping is tabled in ``mesh.py``).
The sharded entries take DTensors (or tensors every rank holds whole) and
return DTensors sharded on the named mesh dimension.
"""

from .mesh import (  # noqa: F401
    CHANNEL_AXIS,
    HOST_AXIS,
    TIME_AXIS,
    DeviceMesh,
    DTensor,
    Replicate,
    Shard,
    channel_time_mesh,
    dsp_mesh,
    init_local_group,
    init_multihost,
    multihost_mesh,
)
from .sharded import (  # noqa: F401
    halo_exchange_left,
    shard_channels,
    sharded_fir_ols,
    sharded_partitioned_fir,
)
from .dist_fft import (  # noqa: F401
    rspectrum_order,
    sharded_fft_convolve,
    sharded_fft_planes,
    sharded_ifft_planes,
    sharded_irfft_planes,
    sharded_rfft_convolve,
    sharded_rfft_planes,
    spectrum_order,
)
