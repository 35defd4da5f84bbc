"""Multi-host (multi-process) runtime scaffolding.

The reference is a single-OS-process system (SURVEY.md §2.4); this
module scales the distributed bundle adjuster across hosts (BASELINE
config #5: keyframe/map-block sharding over >=2 hosts).  Multi-host
hardware is not available to the tests, so this module provides the
process-spanning entry path — ``jax.distributed.initialize`` plus a
global-mesh constructor and host-data sharding helpers — and the
2-process CPU test (tests/test_multihost_ba.py) proves the sharded GBA
solves correctly across a process-spanning mesh.

On real hardware the same entry path is used verbatim:

    from orb_line_slam_tpu.parallel import multihost
    multihost.initialize(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh()
    ba = make_distributed_ba_cg(mesh, cam, ...)
"""

from __future__ import annotations

import os


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
):
    """Join (or start, for process 0) a multi-process JAX runtime.

    local_device_count forces N virtual CPU devices per process —
    the CPU-only testing path; leave None on accelerator hosts where
    the PJRT runtime reports the local devices."""
    if local_device_count is not None:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={local_device_count}"
        ).strip()
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax


def global_mesh(axis_name: str = "dp"):
    """1-D mesh over every device of every process."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def make_global_array(mesh, x, spec):
    """Build a process-spanning jax.Array from an identical host copy
    of `x` on every process (inputs here are small solver operands; the
    data-parallel axis is sharded by `spec`)."""
    import jax
    from jax.sharding import NamedSharding

    s = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])
