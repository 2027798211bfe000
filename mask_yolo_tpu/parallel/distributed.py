"""Multi-host initialization and data placement.

The reference is strictly single-process/single-device
(/root/reference/myolo/config.py:47 GPU_COUNT=0; SURVEY.md §2.3 records the
absence of any distributed backend). The scale-out recipe this module
provides (SURVEY §2.3, `jax.distributed`):

 1. every host process calls `initialize()` (env-driven, no-op when
    single-process) — the coordinator/num_processes/process_id triplet
    comes from the arguments or the env;
 2. all processes build the SAME global mesh over `jax.devices()` (which,
    after initialize, is the GLOBAL device list);
 3. each process loads only its slice of the data (`local_image_ids`) and
    assembles the global batch with `jax.make_array_from_process_local_data`
    (`global_batch_from_local` / mesh.shard_batch route through it
    automatically when process_count > 1);
 4. the jitted train step is unchanged: XLA inserts the gradient psums
    across every device of every process.

Checkpointing: params/opt-state are replicated over 'data', so every process
holds full copies; write from process 0 only (`is_chief`).

Tested end-to-end with 2 processes × 4 virtual CPU devices via gloo
collectives (tests/test_distributed.py).
"""

from __future__ import annotations

import os

import jax
import numpy as np

_ENV_PREFIX = "MYOLO"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None) -> tuple[int, int]:
    """Join the multi-host job. Arguments default to env vars
    MYOLO_COORDINATOR / MYOLO_NUM_PROCESSES / MYOLO_PROCESS_ID (matching the
    jax.distributed.initialize triplet); with none set and no cluster
    environment, this is a single-process no-op.

    Nothing detects a GPU cluster by itself: pass the triplet (e.g.
    coordinator_address="localhost:<port>" for the processes of one host)
    or set it in the env. Returns (process_index, process_count).
    """
    coordinator_address = coordinator_address or os.environ.get(
        f"{_ENV_PREFIX}_COORDINATOR")
    if num_processes is None and f"{_ENV_PREFIX}_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ[f"{_ENV_PREFIX}_NUM_PROCESSES"])
    if process_id is None and f"{_ENV_PREFIX}_PROCESS_ID" in os.environ:
        process_id = int(os.environ[f"{_ENV_PREFIX}_PROCESS_ID"])

    try:
        from jax._src import distributed as _internal
        already = _internal.global_state.client is not None
    except Exception:
        already = False
    if not already and coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    elif not already and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        # the standard JAX env triplet
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()


def shutdown():
    """Leave the multi-host job (idempotent)."""
    try:
        jax.distributed.shutdown()
    except Exception:
        pass


def is_chief() -> bool:
    """True on the process that should write checkpoints / logs."""
    return jax.process_index() == 0


def local_image_ids(image_ids, process_index: int | None = None,
                    process_count: int | None = None) -> np.ndarray:
    """This process's slice of a dataset's image ids (per-process data
    loading). Strided split so class balance survives ordered datasets;
    every process gets the same count (trailing remainder dropped, keeping
    global batches full and static)."""
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    ids = np.asarray(image_ids)
    per = len(ids) // process_count
    if per == 0:
        raise ValueError(
            f"{len(ids)} images cannot feed {process_count} processes")
    return ids[process_index::process_count][:per]


def global_batch_from_local(batch: dict, mesh, sharding=None) -> dict:
    """Assemble the global batch from this process's local shard.

    batch: dict of host arrays whose leading dim is the LOCAL batch size
    (global_batch / process_count). Returns jax Arrays with global shape,
    batch-sharded over the mesh's 'data' axis."""
    from .mesh import batch_sharding

    sh = sharding if sharding is not None else batch_sharding(mesh)
    return {k: jax.make_array_from_process_local_data(sh, np.asarray(v))
            for k, v in batch.items()}
