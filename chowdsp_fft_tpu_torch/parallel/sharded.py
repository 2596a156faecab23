"""Sharded streaming convolution over ``torch.distributed`` (counterpart of
``chowdsp_fft_tpu/parallel/sharded.py``).

A long stream is split into contiguous time shards across a mesh axis.
Linear convolution across a shard boundary needs the last (taps-1)
samples of the left neighbour's shard: a halo hop, rank i to rank i+1
with no wraparound, so rank 0 receives zeros (the stream's zero initial
state, as JAX's ``ppermute`` gives device 0). The hop is one
``batch_isend_irecv``; on a group of one rank it has no operations and
no call is made.

The hop is an autograd Function (:class:`_HaloHop`): its backward is the
reverse hop, rank i+1 to rank i. A plain collective would cut the graph
and leave the upstream gradient quietly missing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..stream import fir_filter_ols, partitioned_fir_apply
from .mesh import CHANNEL_AXIS, TIME_AXIS, DeviceMesh, axis_group, local_shard, replicated, sharded

__all__ = [
    "halo_exchange_left",
    "sharded_fir_ols",
    "sharded_partitioned_fir",
    "shard_channels",
]


def _comm_view(t: torch.Tensor) -> torch.Tensor:
    """A complex buffer is sent as its real view (float pairs)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _hop(send: torch.Tensor, group, size: int, index: int, step: int):
    """Post a one-step shift along the axis: ``send`` goes to index+step,
    the returned buffer receives from index-step (zeros where there is no
    such rank). Returns (receive buffer, requests); no call on one rank."""
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= index + step < size:
        ops.append(dist.P2POp(dist.isend, _comm_view(send), dist.get_global_rank(group, index + step), group))
    if 0 <= index - step < size:
        ops.append(dist.P2POp(dist.irecv, _comm_view(recv), dist.get_global_rank(group, index - step), group))
    return recv, (dist.batch_isend_irecv(ops) if ops else [])


class _PendingTail:
    """A halo hop in flight: this rank's tail (a private copy) posted to
    the right neighbour, the left neighbour's tail posted to be received."""

    def __init__(self, tail: torch.Tensor, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self._send = tail.detach().resolve_conj().resolve_neg().clone(memory_format=torch.contiguous_format)
        self._recv, self._reqs = _hop(self._send, group, size, index, +1)

    def wait(self) -> torch.Tensor:
        for req in self._reqs:
            req.wait()
        return self._recv


class _HaloHop(torch.autograd.Function):
    """The received tail of a posted hop; backward sends the gradient of
    the received tail back to its sender (rank i+1 to rank i)."""

    @staticmethod
    def forward(ctx, tail, pending: _PendingTail):
        ctx.pending = pending
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        p = ctx.pending
        grad, reqs = _hop(g.contiguous(), p.group, p.size, p.index, -1)
        for req in reqs:
            req.wait()
        return grad, None


def _post_tail_left(x_local: torch.Tensor, halo: int, mesh: DeviceMesh, axis_name: str):
    """Post the single-hop exchange of the last ``halo`` samples: returns
    (this rank's tail, the pending hop). A halo longer than the local
    shard would need a multi-hop exchange; halo == 0 would make
    ``x[..., -0:]`` silently select the WHOLE chunk. Both raise."""
    t_loc = x_local.shape[-1]
    if halo == 0:
        raise ValueError("halo must be > 0 (a zero halo needs no exchange)")
    if halo > t_loc:
        raise ValueError(
            f"halo ({halo}) exceeds the local shard length ({t_loc}); "
            "use fewer devices or longer shards (single-hop halo exchange)"
        )
    tail = x_local[..., -halo:]
    return tail, _PendingTail(tail, *axis_group(mesh, axis_name))


def _ship_tail_left(x_local: torch.Tensor, halo: int, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """The last ``halo`` samples of the left neighbour's shard (zeros on
    the axis's first rank), differentiable."""
    tail, pending = _post_tail_left(x_local, halo, mesh, axis_name)
    return _HaloHop.apply(tail, pending)


def halo_exchange_left(x_local: torch.Tensor, halo: int, mesh: DeviceMesh, axis_name: str = TIME_AXIS) -> torch.Tensor:
    """This rank's shard (..., T_loc) prefixed with the last ``halo``
    samples of its left neighbour's (zeros on the first rank). JAX's runs
    inside ``shard_map`` on the axis name; here the mesh names the group.
    halo == 0 is a no-op."""
    if halo == 0:
        return x_local
    return torch.cat([_ship_tail_left(x_local, halo, mesh, axis_name), x_local], dim=-1)


def _sharded_stream_filter(local_filter, x, mesh: DeviceMesh, axis_name: str, halo: int):
    """The overlap structure of the JAX package: the main filter runs on
    the bare local shard (zero left history), the halo hop is posted
    before it and waited on after it, and only a small boundary
    correction (the filter of the received tail, zero-padded by
    ``halo``: convolution is linear) reads the received samples and
    patches the first ``halo`` outputs. On NCCL the hop runs on its own
    stream while the main filter's block FFTs run on the card.
    ``local_filter`` maps a (..., T) stream to its filtered (..., T)."""
    xl = local_shard(x, mesh, axis_name, -1)
    if halo == 0:
        return sharded(local_filter(xl), mesh, axis_name, -1)
    tail, pending = _post_tail_left(xl, halo, mesh, axis_name)
    y_main = local_filter(xl)
    left = _HaloHop.apply(tail, pending)
    corr = local_filter(F.pad(left, (0, halo)))[..., halo:]
    y = torch.cat([y_main[..., :halo] + corr, y_main[..., halo:]], dim=-1)
    return sharded(y, mesh, axis_name, -1)


def sharded_fir_ols(x, h, mesh: DeviceMesh, axis_name: str = TIME_AXIS, block: int | None = None):
    """Overlap-save FIR of a time-sharded stream (..., T): equal to
    ``stream.fir_filter_ols`` of the gathered stream. ``x`` is a DTensor
    sharded along its last dim over ``axis_name`` or a tensor every rank
    holds whole; ``h`` (taps,) is replicated. Returns the DTensor sharded
    the same way. The halo hop (taps-1 samples a boundary) is the only
    traffic between ranks."""
    hl = replicated(h, mesh, axis_name)
    return _sharded_stream_filter(lambda xl: fir_filter_ols(xl, hl, block=block), x, mesh, axis_name,
                                  halo=hl.shape[-1] - 1)


def sharded_partitioned_fir(x, h, mesh: DeviceMesh, axis_name: str = TIME_AXIS, block: int = 1024):
    """Partitioned (FDL) convolution of a time-sharded stream; the same
    contract as :func:`sharded_fir_ols`."""
    hl = replicated(h, mesh, axis_name)
    return _sharded_stream_filter(lambda xl: partitioned_fir_apply(xl, hl, block=block), x, mesh, axis_name,
                                  halo=hl.shape[-1] - 1)


def shard_channels(x, mesh: DeviceMesh, axis_name: str = CHANNEL_AXIS, dim: int = 0):
    """A (C, ...) channel batch as a DTensor sharded along ``dim`` over the
    mesh axis: per-channel transforms then run on each rank's shard with
    no communication. A tensor every rank holds whole is split in place
    (no traffic)."""
    return sharded(local_shard(x, mesh, axis_name, dim), mesh, axis_name, dim)
