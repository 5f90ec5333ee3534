"""The collectives of the data-parallel step, with their gradients.

The port's own module (JAX's GSPMD derives these from the shardings):

* :func:`all_gather_rows` — the ranks' rows stacked in rank order, the
  global batch, on every rank.  Its backward all-reduces the incoming
  gradient and returns this rank's rows: every rank computes the same
  global loss from the gathered rows, so the sum is N times the gradient
  of this rank's rows, and the mean of the parameter gradients over the
  ranks (:func:`mean_gradients`) is then exactly the one-process gradient,
  for the encoders (whose gradient is partial on each rank) and for the
  heads' parameters (complete on each rank) alike.
  ``torch.distributed.nn.functional.all_gather`` is not used: its backward
  is an ``all_to_all``, which gloo does not offer.
* :func:`all_reduce_sum` — a sum over the ranks whose backward is the same
  sum (the batch norms' global statistics).
* :func:`mean_gradients` — one all-reduce of the flat gradient.
* :func:`broadcast_` — rank 0's tensors on every rank (the replicas at
  init), and :func:`checksum` for the check that they stay equal.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        r0 = ctx.mesh.rank * ctx.rows
        return g[r0:r0 + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``x [b, ...]`` concatenated in rank order, ``[N b,
    ...]``, over ``mesh``'s data group (differentiable)."""
    return _AllGatherRows.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (differentiable: the gradient is
    summed over the ranks too)."""
    return _AllReduceSum.apply(x)


def mean_gradients(grads: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The gradients averaged over the ranks: one all-reduce of their flat
    concatenation, returned as views of it shaped like ``grads``."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(mesh.n_data)
    views = flat.split([g.numel() for g in grads])
    return [v.view_as(g) for v, g in zip(views, grads)]


def all_reduce_mean_(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` averaged over the ranks, in place."""
    dist.all_reduce(x)
    return x.div_(mesh.n_data)


def broadcast_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Rank 0's ``tensors`` on every rank, in place: one broadcast of one
    flat buffer per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, 0)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def checksum(tensors: Sequence[torch.Tensor]) -> int:
    """A 63-bit checksum of the bits of ``tensors`` (position-weighted, so a
    change anywhere changes it with near certainty)."""
    total = 0
    for t in tensors:
        bits = t.detach().reshape(-1).contiguous()
        bits = bits.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                          1: torch.uint8}[bits.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), dtype=torch.int64, device=bits.device) % 65521 + 1
        total = (total * 1000003 + int((bits * weight).sum())) % (2 ** 63 - 1)
    return total


def gather_objects(obj, mesh) -> list:
    """Every data rank's picklable ``obj``, in rank order, on every rank (over
    ``mesh``'s data group)."""
    out = [None] * mesh.n_data
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def broadcast_object(obj, mesh):
    """Rank 0's picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]
