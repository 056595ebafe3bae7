"""The cubed-sphere element mesh of HOMME (E3SM components/homme/src/share/
cube_mod.F90, the equiangular gnomonic cube): 6 faces of ne x ne elements,
nelemd = 6 * ne^2, each element np x np = 4 x 4 GLL points.

NUMBERING — face-major, row-major within a face: element (f, a, b) is
e = f*ne^2 + a*ne + b; its GLL i axis runs along a and its j axis along b.
Face f is the square O_f + a*U_f + b*V_f (a, b in [0, ne]) of the cube
[0, ne]^3, with U_f x V_f its outward normal (FACES), so every face is
oriented alike seen from outside.  HOMME orders its elements along a
space-filling curve instead; nothing below depends on the order: `order`
lays the elements out in any other one.

EDGES — edge 0 is i = 0, edge 1 j = np-1, edge 2 i = np-1, edge 3 j = 0;
point k (0..np-1) of an edge runs along j on edges 0 and 2 and along i on
edges 1 and 3 (EDGE_POINTS).  `neighbours` finds each edge's other element
by the cube positions of its two ends, so a seam between faces comes out
with the neighbour's edge (rotated axes) and whether its points run the
other way (reversed).  Inside a face the neighbours are the elements beside.

ASSEMBLY MAP — for the 12 boundary points of every element (BOUNDARY, in
row-major order), the other elements' points that are the same degree of
freedom, as rows e'*16 + p' of an (nelemd*16, ...) field, up to 3 a point,
padded with -1: the one across the edge for a point inside an edge; for an
element corner, the elements met walking round the vertex from edge to
edge until the walk is back (3 inside a face, 2 at the 8 cube corners,
whose vertices have 3 sharers).  DSS(s) at a point is s plus its sharers'
s, summed in the map's slot order; W = 1 / DSS(spheremp).

Everything is built with integer operations on the device of the call.
"""

from __future__ import annotations

import math

import torch

from cdk_torch.core.registry import UnsupportedConfigError
from cdk_torch.core.trace import span

NPG = 4
NPTS = NPG * NPG
SHARERS = 3  # most other sharers of one point (a vertex inside a face)
# (origin, U, V) of each face in units of ne on the cube [0, ne]^3:
# four faces round the equator, then the top and the bottom
FACES = (
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((1, 1, 0), (-1, 0, 0), (0, 0, 1)),
    ((0, 1, 0), (0, -1, 0), (0, 0, 1)),
    ((0, 0, 0), (1, 0, 0), (0, 0, 1)),
    ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    ((0, 0, 0), (0, 1, 0), (1, 0, 0)),
)
# point p = i*np + j of point k of each edge
EDGE_POINTS = (
    tuple(k for k in range(NPG)),                  # i = 0, along j
    tuple(k * NPG + NPG - 1 for k in range(NPG)),  # j = np-1, along i
    tuple((NPG - 1) * NPG + k for k in range(NPG)),  # i = np-1, along j
    tuple(k * NPG for k in range(NPG)),            # j = 0, along i
)
# the element corners each edge runs between, (a, b) offsets of its
# point 0 and its point np-1
EDGE_ENDS = (((0, 0), (0, 1)), ((0, 1), (1, 1)), ((1, 0), (1, 1)),
             ((0, 0), (1, 0)))
# the element's corner points (0, 0), (0, np-1), (np-1, np-1), (np-1, 0) and
# the two edges that meet at each
CORNERS = (0, NPG - 1, NPTS - 1, NPTS - NPG)
CORNER_EDGES = ((0, 3), (0, 1), (1, 2), (2, 3))
# the boundary points in row-major order: the map's slots
BOUNDARY = tuple(p for p in range(NPTS)
                 if p // NPG in (0, NPG - 1) or p % NPG in (0, NPG - 1))


def cube_ne(nelemd: int) -> int:
    """ne of a cube of nelemd = 6 * ne^2 elements; any other count is
    refused."""
    ne = math.isqrt(max(nelemd, 0) // 6)
    if ne < 1 or 6 * ne * ne != nelemd:
        raise UnsupportedConfigError(
            f"a cubed sphere has nelemd = 6 * ne^2 elements (6, 24, 54, ..., "
            f"5400 for ne30); got nelemd={nelemd}")
    return ne


def _ends(ne: int, device) -> torch.Tensor:
    """(6*ne^2, 4, 2) the cube positions of each edge's point-0 and
    point-(np-1) ends, each position one integer x*(ne+1)^2 + y*(ne+1) + z,
    face-major order."""
    f, a, b = torch.meshgrid(*(torch.arange(n, device=device)
                               for n in (6, ne, ne)), indexing="ij")
    f, a, b = f.reshape(-1), a.reshape(-1), b.reshape(-1)
    faces = torch.tensor(FACES, device=device)  # (6, 3, 3)
    o, u, v = (faces[f, k] for k in range(3))   # (E, 3) each
    d = torch.tensor(EDGE_ENDS, device=device)  # (4, 2, 2)
    pos = (o[:, None, None] * ne
           + (a[:, None, None, None] + d[None, ..., 0, None]) * u[:, None, None]
           + (b[:, None, None, None] + d[None, ..., 1, None]) * v[:, None, None])
    scale = torch.tensor([(ne + 1) ** 2, ne + 1, 1], device=device)
    return (pos * scale).sum(-1)


def neighbours(ne: int, device=None, order: torch.Tensor | None = None):
    """Each element's edge neighbours -> (nbr, nedge, reversed), each
    (nelemd, 4): across edge s of element e lies element nbr[e, s], on its
    edge nedge[e, s]; point k of e's edge is point np-1-k of the
    neighbour's where reversed[e, s], else point k.  `order` (a permutation
    of the face-major element numbers) lays the elements out in its order:
    element i is face-major element order[i]."""
    ends = _ends(ne, device)
    if order is not None:
        ends = ends[order.to(device)]
    nelem = ends.shape[0]
    lo, hi = ends.min(-1).values, ends.max(-1).values
    key = (lo * (ne + 1) ** 3 + hi).reshape(-1)
    # every edge of the cube is two element edges: sorted, a pair sits
    # side by side
    srt = torch.argsort(key, stable=True)
    pair = srt.reshape(-1, 2)
    if not torch.equal(key[pair[:, 0]], key[pair[:, 1]]):
        raise ValueError("an element edge without exactly one other")
    other = torch.empty_like(srt)
    other[pair[:, 0]] = pair[:, 1]
    other[pair[:, 1]] = pair[:, 0]
    first = ends[..., 0].reshape(-1)
    nbr = (other // 4).reshape(nelem, 4)
    nedge = (other % 4).reshape(nelem, 4)
    rev = (first != first[other]).reshape(nelem, 4)
    return nbr, nedge, rev


def assembly_map(nbr, nedge, rev) -> torch.Tensor:
    """(nelemd, 12, 3) int32: for each boundary point (BOUNDARY order) of
    each element, its other sharers as rows e'*16 + p', in the order the
    DSS sums them, padded with -1 (`neighbours` gives the arguments)."""
    device = nbr.device
    nelem = nbr.shape[0]
    ep = torch.tensor(EDGE_POINTS, device=device)      # (4 edges, np)
    slot = torch.full((NPTS,), -1, dtype=torch.long, device=device)
    slot[list(BOUNDARY)] = torch.arange(len(BOUNDARY), device=device)
    amap = torch.full((nelem, len(BOUNDARY), SHARERS), -1, dtype=torch.long,
                      device=device)
    e = torch.arange(nelem, device=device)
    # the points inside an edge: the one across it
    for k in range(1, NPG - 1):
        kk = torch.where(rev, NPG - 1 - k, k)          # (E, 4)
        there = nbr * NPTS + ep[nedge, kk]
        for s in range(4):
            amap[e, slot[ep[s, k]], 0] = there[:, s]
    # the corners: walk round the vertex.  Corner c lies at end `end` (0:
    # point 0, 1: point np-1) of edge s; the walk leaves the element by
    # that edge, enters the neighbour at its corner there and leaves it by
    # its other edge at that corner, until it is back at e
    corner_pt = torch.tensor(CORNERS, device=device)
    at = torch.tensor(CORNER_EDGES, device=device)     # (4 corners, 2 edges)
    corner = torch.tensor([[CORNERS.index(EDGE_POINTS[s][0]),
                            CORNERS.index(EDGE_POINTS[s][-1])]
                           for s in range(4)], device=device)
    for c in range(4):
        x = e
        s = torch.full_like(e, CORNER_EDGES[c][0])
        end = (corner[s, 1] == c).long()
        back = torch.zeros_like(e, dtype=torch.bool)
        for h in range(SHARERS):
            y, ys = nbr[x, s], nedge[x, s]
            yc = corner[ys, torch.where(rev[x, s], 1 - end, end)]
            back = back | (y == e)
            amap[e, slot[CORNERS[c]], h] = torch.where(
                back, -1, y * NPTS + corner_pt[yc])
            s = torch.where(at[yc, 0] == ys, at[yc, 1], at[yc, 0])
            end = (corner[s, 1] == yc).long()
            x = y
    return amap.to(torch.int32)


def build_map(nelemd: int, device=None,
              order: torch.Tensor | None = None) -> torch.Tensor:
    """The assembly map of the cube of nelemd elements (`assembly_map`),
    under span `cdk.cube.map`; `order` as `neighbours` takes it."""
    with span("cdk.cube.map"):
        return assembly_map(*neighbours(cube_ne(nelemd), device, order))
