"""Single-process stand-in for the multi-host layer.

The JAX package merges statistics across processes through jax.distributed
(gfalign_tpu/parallel/dist.py).  The port runs one process until the
torch.distributed slice lands: `process_info()` reports (0, 1), and the
collectives raise instead of pretending to merge.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def process_info() -> Tuple[int, int]:
    """(process_index, process_count): always (0, 1) in this slice."""
    return 0, 1


def allreduce_stats(values: Sequence[int]) -> List[int]:
    raise NotImplementedError("distributed runs are a later slice")


def allgather_bytes(payload: bytes) -> List[bytes]:
    raise NotImplementedError("distributed runs are a later slice")
