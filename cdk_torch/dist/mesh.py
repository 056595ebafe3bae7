"""A mesh of P logical shards on one device (the port of ``cdk_tpu.dist.mesh``).

The JAX package decomposes over a 1-D `jax.sharding.Mesh`: one device per
shard, or virtual CPU devices in one process for its tests.  One card
cannot host several NCCL ranks, so the port's mesh is the counterpart of
the virtual-device mesh: P shards in one process on one torch.device.

A sharded x-field is one contiguous tensor with a leading shard axis,
(P, S, chunk, ·), so each shard's block is contiguous for its kernel
launch; shards launch one after another on the current stream.  The
collectives the decomposed steps use, the halo exchange (`lax.ppermute`)
and the flux sum (`lax.psum`), sit behind `exchange_strips`, `exchange`
and `psum`, so a multi-process mesh can replace them with collectives.

The DSS families decompose a periodic element ring or torus, whose
exchange wraps around the whole domain as `lax.ppermute` does:
`ring_strips` and `ring_exchange` (no zeros at the ends).  `make_mesh2d`
is the (pi, pj) grid of shards the 2-D torus decomposition runs on; its
sharded fields lead with both shard axes, and `ring_strips` exchanges
along either.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cdk_torch.core.platform import resolve_device
from cdk_torch.core.trace import span


@dataclass(frozen=True)
class Mesh:
    """P logical shards on one device."""

    size: int
    device: torch.device


def make_mesh(n: int = 1, device="cuda") -> Mesh:
    """A mesh of n shards on `device` (cuda needs a Hopper card, as
    everywhere in the port)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard (got {n})")
    return Mesh(n, resolve_device(device))


def shard_x(a: torch.Tensor, mesh: Mesh, chunk: int) -> torch.Tensor:
    """(S, X, ·) -> (P, S, chunk, ·): zero-pad x to P·chunk columns and give
    shard p the columns [p·chunk, (p+1)·chunk), contiguous on the mesh's
    device."""
    s, x = a.shape[:2]
    pad = mesh.size * chunk - x
    if pad < 0:
        raise ValueError(f"{x} columns do not fit {mesh.size} x {chunk}")
    with span("cdk.layout"):
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        return (a.reshape(s, mesh.size, chunk, *a.shape[2:]).transpose(0, 1)
                .contiguous().to(mesh.device))


def gather_x(a: torch.Tensor) -> torch.Tensor:
    """(P, S, chunk, ·) -> (S, P·chunk, ·), the counterpart of
    `to_host_global` (the tensor stays on its device)."""
    p, s, chunk = a.shape[:3]
    with span("cdk.layout"):
        return a.transpose(0, 1).reshape(s, p * chunk, *a.shape[3:])


def exchange_strips(x: torch.Tensor, h: int, out=None):
    """The h columns each shard receives from its left and right neighbour
    (the `lax.ppermute` pair): left[p] = x[p-1][:, -h:], right[p] =
    x[p+1][:, :h], zeros at the global domain ends.  Each is contiguous,
    (P, S, h, ·).  `out` is a (left, right) pair this function returned
    before for the same shapes: it is refilled in place (its global-end
    zeros stay), so a loop allocates its strips once."""
    if x.shape[2] < h:
        raise ValueError(f"chunk {x.shape[2]} < halo {h}")
    with span("cdk.dist.exchange"):
        if out is None:
            out = (torch.zeros_like(x[:, :, :h]), torch.zeros_like(x[:, :, :h]))
        left, right = out
        left[1:] = x[:-1, :, -h:]
        right[:-1] = x[1:, :, :h]
        return left, right


def exchange(x: torch.Tensor, h: int) -> torch.Tensor:
    """x extended by h neighbour columns on each side: (P, S, chunk + 2h, ·)."""
    with span("cdk.dist.exchange"):
        left, right = exchange_strips(x, h)
        return torch.cat([left, x, right], dim=2)


def ring_strips(x: torch.Tensor, h: int, shard_dim: int = 0, dim: int = 1,
                out=None):
    """The h entries each shard receives from its neighbours along shard axis
    `shard_dim` of a periodic domain, whose axis `dim` the shards split:
    left[p] = x[p-1 mod P][-h:], right[p] = x[p+1 mod P][:h] on that axis
    (one shard receives its own ends).  New strips are contiguous; `out`
    is a (left, right) pair of tensors (or views) of their shapes, refilled
    in place."""
    n, P = x.shape[dim], x.shape[shard_dim]
    if n < h:
        raise ValueError(f"{n} entries per shard < halo {h}")
    tail, head = x.narrow(dim, n - h, h), x.narrow(dim, 0, h)
    with span("cdk.dist.exchange"):
        if out is None:
            out = (x.new_empty(tail.shape), x.new_empty(head.shape))
        left, right = out
        # left[p] = tail[p-1], right[p] = head[p+1], wrapping over the P shards
        left.narrow(shard_dim, 1, P - 1).copy_(tail.narrow(shard_dim, 0, P - 1))
        left.narrow(shard_dim, 0, 1).copy_(tail.narrow(shard_dim, P - 1, 1))
        right.narrow(shard_dim, 0, P - 1).copy_(head.narrow(shard_dim, 1, P - 1))
        right.narrow(shard_dim, P - 1, 1).copy_(head.narrow(shard_dim, 0, 1))
        return left, right


def ring_exchange(x: torch.Tensor, h: int, shard_dim: int = 0,
                  dim: int = 1) -> torch.Tensor:
    """x extended by h periodic neighbour entries on each side of axis dim."""
    with span("cdk.dist.exchange"):
        left, right = ring_strips(x, h, shard_dim, dim)
        return torch.cat([left, x, right], dim=dim)


@dataclass(frozen=True)
class Mesh2d:
    """A (pi, pj) grid of logical shards on one device: pi splits element
    rows (the i direction), pj element columns (j)."""

    shape: tuple[int, int]
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_mesh2d(n: int | None = None, shape: tuple[int, int] | None = None,
                device="cuda") -> Mesh2d:
    """A 2-D mesh of n shards (1 where neither is given), factorised
    most-square (8 -> 2 x 4) unless `shape` gives (pi, pj)."""
    if shape is None:
        n = n or 1
        pi = int(n**0.5)
        while n % pi:
            pi -= 1
        shape = (pi, n // pi)
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"a mesh needs at least one shard per axis (got {shape})")
    return Mesh2d(tuple(shape), resolve_device(device))


def psum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard axis in shard order 0..P-1, so the result
    does not depend on scheduling."""
    acc = parts[0]
    for p in range(1, parts.shape[0]):
        acc = acc + parts[p]
    return acc
