"""Multi-host (pod / multi-slice) execution.

The reference scales across nodes with a Slurm job array — one residue per
job (reference scripts/create_jobs.sh:16-20, submit_tmp.slu). The
equivalent here is one SPMD program over every device of a cluster: each host runs
the same driver, ``jax.distributed`` wires the hosts into one runtime, and
the residue/chain lanes shard over the GLOBAL device set. Lane sharding is
collective-free, so cross-host traffic is zero during sampling; only the
final thinned-sample gather crosses DCN.

Typical launch (same command on every host; a Slurm/MPI launcher or
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
supply the coordinator and process id):

    python -m basicrta_tpu.cli gibbs --contacts contacts_7.0.npz \
        --multihost --ndevices 0
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["initialize", "is_multihost", "host_residue_partition"]

_initialized = False


def _cluster_env_detected() -> bool:
    """True when the environment advertises a multi-process cluster.

    Used to tell apart 'no cluster here' (an expected single-process
    no-op) from 'there IS a cluster but joining it failed' — the latter
    must never be swallowed, or a degraded host would run single-process,
    get assigned ALL residues by :func:`host_residue_partition`, and race
    the other hosts' writes into the shared results tree.
    """
    env = os.environ
    if env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS"):
        return True
    for var in ("SLURM_JOB_NUM_NODES", "SLURM_NNODES",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        try:
            if int(env.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join this process into the global JAX runtime (idempotent).

    With no arguments, relies on the cluster environment JAX detects
    (Slurm, MPI); when none is present (single process) it degrades to a
    no-op. Otherwise pass the coordinator explicitly or export
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``.

    Must run before anything initializes an XLA backend —
    ``jax.distributed.initialize`` is called FIRST here (never after a
    ``jax.process_count()`` probe, which would itself create the backend
    and make cluster initialization impossible).
    """
    global _initialized
    if _initialized:
        return
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        if kwargs:
            raise          # explicit cluster config failed: surface it
        if _cluster_env_detected():
            # a cluster IS advertised but joining it failed — falling back
            # to single-process would duplicate every other host's work
            # and race their writes into the shared results tree
            raise
        # no explicit config and none auto-detected: single-process run,
        # or the runtime already wired the pod before we got here
    _initialized = True


def is_multihost() -> bool:
    import jax
    return jax.process_count() > 1


def host_residue_partition(labels):
    """This host's residue subset for the recommended pod mapping.

    Residues are independent, so the best multi-host layout is the
    reference's Slurm-array shape run at device speed: every host runs the
    SAME driver over its own residue subset with its LOCAL chips (lane
    sharding via ``--ndevices 0``), writing into the shared
    ``basicrta-{cutoff}/{res}/`` tree. No cross-host arrays, no DCN
    traffic, and the failure/rerun sentinel contract
    (``missing_residues`` + ``--rerun-missing``) works unchanged across
    hosts. Round-robin by sorted order so event-count skew spreads evenly.
    """
    import jax

    labels = sorted(labels)
    n, i = jax.process_count(), jax.process_index()
    return [lab for j, lab in enumerate(labels) if j % n == i]
