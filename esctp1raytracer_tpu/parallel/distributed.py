"""Multi-host bring-up.

The reference's only nod to distribution is a dead CONFIG_MPI compile hook
(reference cmake/config.cmake:76-78) — nothing ever includes MPI. Here
multi-host is first-class: `jax.distributed.initialize()` over ICI/DCN,
after which `jax.devices()` spans the pod slice and the mesh in
sharding.py shards the ray grid across all of it.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from esctp1raytracer_tpu.utils.debug import get_logger

logger = get_logger(__name__)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-host JAX if configured; return process count.

    No-ops on a single host (the common case for tests and one-card runs).
    Arguments default to the standard JAX_* environment variables.
    """
    explicit = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if explicit or os.environ.get("JAX_NUM_PROCESSES"):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            "distributed: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
    return jax.process_count()
