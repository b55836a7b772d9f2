"""Multi-chip sharding of the Gibbs workload.

The reference scales across machines with a Slurm array of one-residue jobs
(reference scripts/create_jobs.sh, submit_tmp.slu); communication is the
filesystem. The device-native equivalents here:

- **lane (data) parallelism**: the residue x chain batch axis is sharded
  over the mesh ('lanes'); each chip sweeps its lanes independently — no
  collectives, matching the embarrassingly parallel structure
  (SURVEY.md section 2, parallelism item 3/5).
- **event (value) parallelism**: for residues too large for one chip's
  comfort, the unique-value axis is sharded over the mesh ('events'); each
  chip draws the multinomial counts for its value slice and the sufficient
  statistics (N_k, T_k) are combined with ``psum`` each sweep (NCCL
  between GPUs) —
  the chain state stays replicated. This is the sequence-parallel analogue
  for this workload (SURVEY.md section 5 'long-context').

Both compose in one ``shard_map`` over a ('lanes', 'events') mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler.kernels import (MixtureState, _conjugate_update,
                                          _log_responsibilities,
                                          _tiered_multinomial)


def make_mesh(n_lanes: Optional[int] = None, n_events: int = 1,
              devices=None) -> Mesh:
    """Build a ('lanes', 'events') mesh over the available devices."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n_lanes is None:
        n_lanes = n // n_events
    assert n_lanes * n_events == n, (n_lanes, n_events, n)
    arr = np.asarray(devices).reshape(n_lanes, n_events)
    return Mesh(arr, ("lanes", "events"))


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (B, ...) batch arrays: lanes split, rest replicated."""
    return NamedSharding(mesh, P("lanes"))


def event_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (B, V) arrays: lanes x events split."""
    return NamedSharding(mesh, P("lanes", "events"))


def deal_columns(values: np.ndarray, counts: np.ndarray, n_shards: int,
                 tiers: Tuple[int, int]):
    """Deal multiplicity-sorted value columns round-robin onto event
    shards, so every shard's contiguous slice stays multiplicity-descending
    and one static tier pair covers all shards.

    Columns sorted descending are distributed cyclically (shard e takes
    columns e, e+E, e+2E, ...) and laid out contiguously per shard — the
    layout a P('lanes','events') sharding splits. Per-shard tier boundaries
    are the ceilings of the global ones (safe: each tier's sampler is exact
    on any smaller count).

    Returns (values, counts, per_shard_tiers).
    """
    V = values.shape[-1]
    if V % n_shards:
        raise ValueError(f"V={V} not divisible by events={n_shards}")
    per = V // n_shards
    # position e*per + j <- old column j*n_shards + e
    old = (np.arange(per)[None, :] * n_shards
           + np.arange(n_shards)[:, None]).reshape(-1)
    head = -(-tiers[0] // n_shards)
    single = max(-(-tiers[1] // n_shards), head)
    return (np.take(values, old, axis=-1), np.take(counts, old, axis=-1),
            (head, single))


def event_sharded_blocks(mesh: Mesh, cfg: GibbsConfig, n_blocks: int,
                         tiers: Optional[Tuple[int, int]] = None):
    """Build the jitted multi-chip sampler step.

    Returns a function ``step(keys, state, values, counts) -> (state, W, R)``
    where:

    - ``keys``: (B,) per-lane PRNG keys,
    - ``state``: MixtureState with (B, K) leaves, replicated over 'events',
    - ``values``/``counts``: (B, V) with B sharded over 'lanes' and V over
      'events' (pad V to a multiple of the events axis with zero counts;
      lay columns out with :func:`deal_columns` to use the tiered sampler).
    - ``tiers``: static per-shard tier boundaries from :func:`deal_columns`
      (None runs the untiered general sampler).

    Each sweep: every chip computes multinomial counts for its value slice,
    ``psum('events')`` combines (N_k, T_k), and the conjugate update runs
    identically on every chip (same key), keeping the state replicated.
    """

    def device_block(keys, w, r, values, counts):
        ev = jax.lax.axis_index("events")

        def lane(key, w0, r0, v, c):
            def block(st, block_key):
                sweep_keys = jax.random.split(block_key, cfg.g)

                def sweep(st, k):
                    kmult, kconj = jax.random.split(k)
                    # per-shard multinomial randomness; shared conjugate key
                    kmult = jax.random.fold_in(kmult, ev)
                    logz = _log_responsibilities(st, v)
                    probs = jax.nn.softmax(logz, axis=-1)
                    m = _tiered_multinomial(kmult, c, probs, tiers)
                    Ns = jax.lax.psum(jnp.sum(m, axis=0), "events")
                    Ts = jax.lax.psum(jnp.matmul(
                        v, m, precision=jax.lax.Precision.HIGHEST),
                        "events")
                    return _conjugate_update(kconj, Ns, Ts, cfg.alpha_eff,
                                             cfg.gamma_shape,
                                             cfg.gamma_rate), None

                st, _ = jax.lax.scan(sweep, st, sweep_keys)
                return st, (st.weights, st.rates)

            block_keys = jax.random.split(key, n_blocks)
            st, (W, R) = jax.lax.scan(block, MixtureState(w0, r0), block_keys)
            return st, W, R

        st, W, R = jax.vmap(lane)(keys, w, r, values, counts)
        return st, W, R

    shard = jax.shard_map(
        device_block, mesh=mesh,
        in_specs=(P("lanes"), P("lanes", None), P("lanes", None),
                  P("lanes", "events"), P("lanes", "events")),
        out_specs=(MixtureState(P("lanes", None), P("lanes", None)),
                   P("lanes", None, None), P("lanes", None, None)),
        check_vma=False)

    @jax.jit
    def step(keys, state: MixtureState, values, counts):
        st, W, R = shard(keys, state.weights, state.rates, values, counts)
        return MixtureState(st.weights, st.rates), W, R

    return step


def sharded_training_step(mesh: Mesh, cfg: GibbsConfig, n_blocks: int = 1):
    """The full multi-chip 'training step' used by the driver dry-run:
    lanes (residues x chains) sharded over 'lanes', unique values sharded
    over 'events' with per-sweep psum of the sufficient statistics."""
    return event_sharded_blocks(mesh, cfg, n_blocks)
