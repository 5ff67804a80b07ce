"""The (data, cand) grid of the two-axis scoring step.

The JAX package lays its devices out as a jax.sharding.Mesh with two axes
(gfalign_tpu/parallel/mesh.py):

  * axis "data": read/GAF batches (data parallel; stat merges are sums);
  * axis "cand": candidate paths of a search frontier (the scoring
    matrix's other dimension).

The port lays the ranks of a torch.distributed process group out on the
same grid, rank p at (p // cand, p % cand) (parallel/score_step.py
`sharded_scoring_step`).  Graph tensors are small and every rank holds
them whole; read batches and frontier candidates are what is split.
"""

from __future__ import annotations

from typing import Tuple


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """(data, cand) factorization: favor the data axis, keep cand <= 8."""
    cand = 1
    for c in (8, 4, 2):
        if n_devices % c == 0 and n_devices // c >= c // 2:
            cand = c
            break
    if n_devices % cand:
        cand = 1
    return n_devices // cand, cand


def grid_position(rank: int, grid: Tuple[int, int]) -> Tuple[int, int]:
    """(data index, cand index) of `rank` on a (data, cand) grid."""
    data, cand = grid
    if not 0 <= rank < data * cand:
        raise ValueError(f"rank {rank} is not on a {data} x {cand} grid")
    return rank // cand, rank % cand
