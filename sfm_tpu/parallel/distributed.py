"""Multi-process initialization.

One process driving all the GPUs of one host needs nothing:
``data_mesh()`` spans ``jax.devices()``.  A run with several processes
(one per host, or one per card) calls :func:`initialize_multihost` once per
process, before any jax computation, with the coordinator's address, the
process count and this process's id — nothing discovers them.  Afterwards
``jax.devices()`` spans every process's cards and the same mesh/shard_map
code paths (ba.sharded, mvs.expand) run unchanged; XLA hands the
collectives to NCCL.  The reference has no distributed backend at all
(SURVEY.md §5).

CI covers the single-process path and the argument plumbing.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize jax.distributed (no-op for a single process).

    A multi-process run must pass all three arguments, e.g.
    ``coordinator_address="localhost:12345"``.  Returns a summary dict.
    """
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "a multi-process run needs coordinator_address and "
                "process_id as well as num_processes"
            )
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
