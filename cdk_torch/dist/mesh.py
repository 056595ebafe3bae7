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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cdk_torch.core.platform import resolve_device


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
    a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    return (a.reshape(s, mesh.size, chunk, *a.shape[2:]).transpose(0, 1)
            .contiguous().to(mesh.device))


def gather_x(a: torch.Tensor) -> torch.Tensor:
    """(P, S, chunk, ·) -> (S, P·chunk, ·), the counterpart of
    `to_host_global` (the tensor stays on its device)."""
    p, s, chunk = a.shape[:3]
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
    if out is None:
        out = (torch.zeros_like(x[:, :, :h]), torch.zeros_like(x[:, :, :h]))
    left, right = out
    left[1:] = x[:-1, :, -h:]
    right[:-1] = x[1:, :, :h]
    return left, right


def exchange(x: torch.Tensor, h: int) -> torch.Tensor:
    """x extended by h neighbour columns on each side: (P, S, chunk + 2h, ·)."""
    left, right = exchange_strips(x, h)
    return torch.cat([left, x, right], dim=2)


def psum(parts: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard axis in shard order 0..P-1, so the result
    does not depend on scheduling."""
    acc = parts[0]
    for p in range(1, parts.shape[0]):
        acc = acc + parts[p]
    return acc
