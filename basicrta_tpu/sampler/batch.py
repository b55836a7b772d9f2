"""Batched multi-residue Gibbs sampling.

The reference fans out one OS process per residue
(reference gibbs.py:73-88, scripts/create_jobs.sh) — 300+ single-core Python
loops. Here every residue (x every chain) is one lane of a single batched
device program: residues are bucketed by unique-value count, padded, stacked,
and swept together in one program per bucket, so per-sweep latency is
amortized across the whole batch.

Sampling proceeds in host-level *segments* of whole thinning blocks so long
runs can report progress and checkpoint (the reference has no mid-run
checkpointing; a preempted 110k-sweep job restarts from zero,
cf. SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.sampler.kernels import (MixtureState, collapsed_sweep,
                                          compute_tiers, dedup_times,
                                          init_mixture_params)


def _next_pow2(n: int, floor: int = 128, step: int = 2) -> int:
    """Smallest floor * step^k >= n (the geometric ladder every padded
    compile signature in the package quantizes to)."""
    b = floor
    while b < n:
        b *= step
    return b


@dataclasses.dataclass
class ResidueBatch:
    """A padded, stacked bucket of residues ready for batched sampling.

    Value columns are sorted by multiplicity descending per lane so the
    multiplicity-tiered multinomial sampler applies (kernels.SMALL_NMAX).
    """
    names: List[str]               # residue labels, length B
    values: np.ndarray             # (B, V) unique residence times
    counts: np.ndarray             # (B, V) multiplicities, 0 marks padding
    n_events: np.ndarray           # (B,) true event count per residue
    tiers: Tuple[int, int] = (0, 0)  # static tier boundaries

    @property
    def size(self) -> int:
        return len(self.names)


def bucket_residues(times_per_residue: Dict[str, np.ndarray],
                    floor: Optional[int] = None) -> List[ResidueBatch]:
    """Group residues into buckets on a power-of-two unique-count ladder.

    Residence times are multiples of the trajectory interval, so the unique
    count V is small even for huge residues (the bundled 446,605-event W313
    dataset has V = 870). Each residue goes to the bucket of width
    ``floor * 2^k >= V`` (``floor`` defaults to 128), so small residues do
    not walk the padding columns of the largest one, while the number of
    buckets — each a separate compiled program and launch — stays
    logarithmic in the spread of V. Tier widths are set by each bucket's
    multiplicity profile, so small buckets also carry fewer heavy-sampler
    columns.
    """
    floor = 128 if floor is None else floor
    buckets: Dict[int, list] = {}
    for name, t in times_per_residue.items():
        if len(t) == 0:
            continue
        v, c = dedup_times(t)
        buckets.setdefault(_next_pow2(len(v), floor), []).append((name, v, c))

    out = []
    for V, group in sorted(buckets.items()):
        B = len(group)
        values = np.zeros((B, V), np.float64)
        counts = np.zeros((B, V), np.float64)
        names, n_events = [], []
        for i, (name, v, c) in enumerate(group):
            # padded rows keep value 1.0 (any positive finite) with count 0
            values[i, :len(v)] = v
            values[i, len(v):] = 1.0
            counts[i, :len(c)] = c
            names.append(name)
            n_events.append(int(c.sum()))
        order, tiers = compute_tiers(counts)
        values = np.take_along_axis(values, order, axis=-1)
        counts = np.take_along_axis(counts, order, axis=-1)
        out.append(ResidueBatch(names, values, counts,
                                np.asarray(n_events), tiers))
    return out


ENGINES = ("auto", "xla", "pallas")


def resolve_engine(engine: str, interpret: bool = False) -> str:
    """Validate an engine name and resolve ``'auto'``: the fused kernel on
    an NVIDIA GPU, the XLA engine on any other backend.

    The fused kernel is compiled for the GPU; asking for it on another
    backend is an error unless the caller explicitly asks for the Pallas
    interpreter (tests on the CPU)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    platform = jax.devices()[0].platform
    if engine == "auto":
        return "pallas" if platform == "gpu" else "xla"
    if engine == "pallas" and platform != "gpu" and not interpret:
        raise ValueError(
            f"engine='pallas' runs a kernel compiled for NVIDIA GPUs, but "
            f"the default backend is {platform!r}; use engine='xla' (or "
            f"interpret=True to run the kernel in the Pallas interpreter)")
    return engine


@functools.partial(jax.jit, static_argnames=("cfg", "n_blocks", "tiers"))
def _segment(keys: jax.Array, state: MixtureState, values: jax.Array,
             counts: jax.Array, cfg: GibbsConfig, n_blocks: int,
             tiers: Optional[Tuple[int, int]] = None):
    """Advance every lane by ``n_blocks`` thinning blocks (n_blocks*g sweeps).

    keys: (B,) per-lane keys for this segment. Returns the advanced states
    and the (B, n_blocks, K) thinned samples.
    """
    def lane(key, st, v, c):
        def block(st, block_key):
            sweep_keys = jax.random.split(block_key, cfg.g)
            st, _ = jax.lax.scan(
                lambda s, k: (collapsed_sweep(k, s, v, c, cfg,
                                              tiers=tiers)[0], None),
                st, sweep_keys)
            return st, (st.weights, st.rates)

        block_keys = jax.random.split(key, n_blocks)
        st, (W, R) = jax.lax.scan(block, st, block_keys)
        return st, W, R

    return jax.vmap(lane)(keys, state, values, counts)


@dataclasses.dataclass
class BatchResult:
    names: List[str]
    mcweights: np.ndarray   # (B, S, K)
    mcrates: np.ndarray     # (B, S, K)
    n_events: np.ndarray    # (B,)


def _checkpoint_key(batch: ResidueBatch, cfg: GibbsConfig,
                    engine: str = "xla") -> str:
    import hashlib
    h = hashlib.sha1()
    h.update(",".join(batch.names).encode())
    h.update(cfg.to_json().encode())
    h.update(engine.encode())
    h.update(np.ascontiguousarray(batch.counts).tobytes())
    # values too: the same residues re-extracted with a different timestep
    # scale keep their multiplicities but change every residence time
    h.update(np.ascontiguousarray(batch.values).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, batch: ResidueBatch, cfg: GibbsConfig,
                    done_blocks: int, seg_idx: int, state: MixtureState,
                    Ws: List[np.ndarray], Rs: List[np.ndarray],
                    engine: str = "xla") -> str:
    """Persist mid-run sampler state; atomic via rename."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, key=_checkpoint_key(batch, cfg, engine),
        done_blocks=done_blocks,
        seg_idx=seg_idx,
        weights=np.asarray(state.weights), rates=np.asarray(state.rates),
        W=np.concatenate(Ws, axis=1) if Ws else np.zeros((batch.size, 0, 1)),
        R=np.concatenate(Rs, axis=1) if Rs else np.zeros((batch.size, 0, 1)))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, batch: ResidueBatch, cfg: GibbsConfig,
                    engine: str = "xla"):
    """Returns (done_blocks, seg_idx, state, Ws, Rs) or None when absent or
    mismatched.

    A checkpoint only resumes the exact same workload (same residues,
    counts, and config) — guarded by a content hash.
    """
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["key"]) != _checkpoint_key(batch, cfg, engine):
            return None
        state = MixtureState(jnp.asarray(z["weights"]),
                             jnp.asarray(z["rates"]))
        done = int(z["done_blocks"])
        seg_idx = int(z["seg_idx"])
        Ws = [z["W"]] if z["W"].shape[1] else []
        Rs = [z["R"]] if z["R"].shape[1] else []
    return done, seg_idx, state, Ws, Rs


def run_batch(batch: ResidueBatch, cfg: GibbsConfig,
              segment_blocks: int = 100,
              checkpoint_path: Optional[str] = None,
              checkpoint_cb=None,
              sharding: Optional[jax.sharding.NamedSharding] = None,
              progress_cb=None, engine: str = "xla",
              defer_transfer: bool = False, interpret: bool = False):
    """Run full chains for one bucket of residues.

    Args:
        segment_blocks: thinning blocks per host-level segment (checkpoint /
            progress granularity; 100 blocks = 10,000 sweeps by default).
        checkpoint_path: when set, sampler state is persisted there after
            every segment and a matching checkpoint is resumed from — an
            upgrade over the reference, whose preempted 110k-sweep jobs
            restart from zero (SURVEY.md section 5 checkpoint/resume). The
            RNG is segment-keyed (fold_in of lane key and segment index), so
            a resumed run reproduces the uninterrupted chain exactly.
        checkpoint_cb: optional ``f(segment_idx, state, samples_so_far)``.
        sharding: optional NamedSharding to lay lanes out across a mesh
            (batch axis sharded; see basicrta_tpu.parallel).
        progress_cb: optional ``f(done_sweeps, total_sweeps)``.
        engine: 'xla' (vmapped sweep graph), 'pallas' (the fused segment
            kernel of sampler.pallas_sweep, compiled for NVIDIA GPUs), or
            'auto' (pallas on a GPU, xla elsewhere).
        defer_transfer: return a ``_DeferredBatch`` whose thinned samples
            are still on device — pass it to :func:`finalize_batch`. Lets
            a caller running several buckets dispatch the next bucket's
            segments before this one's results transfer.
        interpret: run the fused kernel in the Pallas interpreter (tests
            on the CPU).

    Returns:
        :class:`BatchResult`, or a ``_DeferredBatch`` when
        ``defer_transfer=True``.
    """
    engine = resolve_engine(engine, interpret)
    mesh = sharding.mesh if sharding is not None else None
    n_lanes = 1
    if mesh is not None:
        n_lanes = mesh.shape.get("lanes", mesh.devices.size)
        if engine == "pallas" and mesh.shape.get("events", 1) > 1:
            raise ValueError(
                "the fused pallas engine runs each lane's whole value axis "
                "in one program and cannot shard it; use an events=1 mesh "
                "(lane sharding) or engine='xla' for event sharding")
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    B = batch.size
    tiers = batch.tiers
    # pad lanes to a multiple of the lane-shard count; padded lanes carry
    # zero counts and are sliced off the results
    Bs = -(-B // n_lanes) * n_lanes
    values_np = np.ones((Bs, batch.values.shape[1]), np.float32)
    values_np[:B] = batch.values
    counts_np = np.zeros((Bs, batch.counts.shape[1]), np.float32)
    counts_np[:B] = batch.counts
    n_events_shards = 1
    if (mesh is not None and engine == "xla"
            and mesh.shape.get("events", 1) > 1
            and sharding.spec and len(sharding.spec) > 1
            and sharding.spec[1] == "events"):
        # explicit event sharding: deal sorted columns cyclically so one
        # static tier pair covers every shard, then run the shard_map step
        # with per-sweep psum of the sufficient statistics
        from basicrta_tpu.parallel.mesh import deal_columns
        n_events_shards = mesh.shape["events"]
        values_np, counts_np, tiers = deal_columns(
            values_np, counts_np, n_events_shards, batch.tiers)
    values = jnp.asarray(values_np)
    counts = jnp.asarray(counts_np)
    state_sharding = sharding
    if sharding is not None:
        values = jax.device_put(values, sharding)
        counts = jax.device_put(counts, sharding)
        if n_events_shards > 1:
            # the (Bs, K) state replicates over 'events' (K is not dealt
            # onto event shards); only the lane axis is split
            from jax.sharding import NamedSharding, PartitionSpec as P
            state_sharding = NamedSharding(mesh, P("lanes"))

    st0 = init_mixture_params(cfg.ncomp)
    state = MixtureState(jnp.tile(st0.weights, (Bs, 1)),
                         jnp.tile(st0.rates, (Bs, 1)))
    if state_sharding is not None:
        state = MixtureState(jax.device_put(state.weights, state_sharding),
                             jax.device_put(state.rates, state_sharding))
    total_blocks = cfg.niter // cfg.g
    # salt the stream by the bucket's residue set: lanes at the same index
    # of DIFFERENT buckets (the default ladder yields several per protein)
    # must not consume identical streams, or their posteriors correlate
    import zlib
    bucket_salt = zlib.crc32(",".join(batch.names).encode()) & 0x7FFFFFFF
    key = jax.random.fold_in(jax.random.key(cfg.seed), bucket_salt)
    lane_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(Bs))

    # sharded runs draw different (per-shard) streams, so checkpoints are
    # keyed by the sharding layout and never resume across mesh shapes
    ckpt_engine = engine
    if n_lanes > 1:
        ckpt_engine += f"-l{n_lanes}"
    if n_events_shards > 1:
        ckpt_engine += f"-ev{n_events_shards}"
    Ws, Rs = [], []
    done = 0
    seg_idx = 0
    if checkpoint_path is not None:
        resumed = load_checkpoint(checkpoint_path, batch, cfg, ckpt_engine)
        if resumed is not None:
            done, seg_idx, ck_state, Ws, Rs = resumed
            # checkpoints store the true-B state; re-pad to the shard count
            pad = Bs - ck_state.weights.shape[0]
            state = MixtureState(
                jnp.pad(ck_state.weights, ((0, pad), (0, 0)),
                        constant_values=1.0),
                jnp.pad(ck_state.rates, ((0, pad), (0, 0)),
                        constant_values=1.0))
            if state_sharding is not None:
                state = MixtureState(
                    jax.device_put(state.weights, state_sharding),
                    jax.device_put(state.rates, state_sharding))
    if engine == "pallas":
        from basicrta_tpu.sampler.pallas_sweep import segment_pallas
        seed0 = jnp.int32((cfg.seed ^ bucket_salt) & 0x7FFFFFFF)

        if mesh is not None and n_lanes > 1:
            from jax.sharding import PartitionSpec as P

            def run_segment(offset, state, nb):
                def _body(seed, off, w, r, v, c):
                    # key each lane's stream by its global index: the
                    # sharded run draws the unsharded run's chains
                    lanes0 = jax.lax.axis_index("lanes") * w.shape[0]
                    st, W, R = segment_pallas(
                        seed, off, MixtureState(w, r), v, c, cfg, nb,
                        tiers, interpret=interpret,
                        lane_offset=lanes0.astype(jnp.int32))
                    return st.weights, st.rates, W, R

                sharded = jax.shard_map(
                    _body, mesh=mesh,
                    in_specs=(P(), P(), P("lanes"), P("lanes"), P("lanes"),
                              P("lanes")),
                    out_specs=(P("lanes"), P("lanes"), P("lanes"),
                               P("lanes")),
                    check_vma=False)
                w, r, W, R = sharded(seed0, jnp.int32(offset),
                                     state.weights, state.rates,
                                     values, counts)
                return MixtureState(w, r), W, R
        else:
            def run_segment(offset, state, nb):
                return segment_pallas(seed0, jnp.int32(offset), state,
                                      values, counts, cfg, nb, tiers,
                                      interpret=interpret)
    event_steps: Dict[int, object] = {}
    while done < total_blocks:
        nb = min(segment_blocks, total_blocks - done)
        if engine == "pallas":
            state, W, R = run_segment(done * cfg.g, state, nb)
        else:
            seg_keys = jax.vmap(
                lambda k: jax.random.fold_in(k, seg_idx))(lane_keys)
            if n_events_shards > 1:
                if nb not in event_steps:
                    from basicrta_tpu.parallel.mesh import (
                        event_sharded_blocks)
                    event_steps[nb] = event_sharded_blocks(mesh, cfg, nb,
                                                           tiers)
                state, W, R = event_steps[nb](seg_keys, state, values,
                                              counts)
            else:
                state, W, R = _segment(seg_keys, state, values, counts,
                                       cfg, nb, tiers)
        if checkpoint_path is not None or checkpoint_cb is not None:
            # checkpointing needs host copies now; otherwise keep the
            # thinned samples on device so the next segment dispatches
            # without a host sync
            W, R = np.asarray(W)[:B], np.asarray(R)[:B]
        Ws.append(W)
        Rs.append(R)
        done += nb
        seg_idx += 1
        if checkpoint_path is not None:
            ck = MixtureState(np.asarray(state.weights)[:B],
                              np.asarray(state.rates)[:B])
            save_checkpoint(checkpoint_path, batch, cfg, done, seg_idx,
                            ck, Ws, Rs, ckpt_engine)
        if checkpoint_cb is not None:
            checkpoint_cb(seg_idx, state, (Ws, Rs))
        if progress_cb is not None:
            # with deferred transfers the loop would otherwise report
            # dispatch progress, not execution progress
            jax.block_until_ready(state.weights)
            progress_cb(done * cfg.g, cfg.niter)

    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    deferred = _DeferredBatch(batch.names, Ws, Rs, batch.n_events, B)
    if defer_transfer:
        # caller pipelines several buckets: the thinned samples stay on
        # device until finalize_batch, so the next bucket's segments
        # dispatch without waiting for this one's transfer
        return deferred
    return finalize_batch(deferred)


@dataclasses.dataclass
class _DeferredBatch:
    """run_batch output with samples still on device (defer_transfer)."""
    names: List[str]
    Ws: list
    Rs: list
    n_events: np.ndarray
    B: int


def finalize_batch(deferred) -> BatchResult:
    """Transfer a ``defer_transfer=True`` result to host."""
    if isinstance(deferred, BatchResult):
        return deferred
    Ws = [np.asarray(w)[:deferred.B] for w in deferred.Ws]
    Rs = [np.asarray(r)[:deferred.B] for r in deferred.Rs]
    return BatchResult(deferred.names, np.concatenate(Ws, axis=1),
                       np.concatenate(Rs, axis=1), deferred.n_events)


def run_residues(times_per_residue: Dict[str, np.ndarray], cfg: GibbsConfig,
                 n_chains: int = 1, checkpoint_dir: Optional[str] = None,
                 **kwargs) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """All-residue driver: bucket, batch, and sweep everything on device.

    Multiple chains per residue are expressed as extra lanes (residue
    repeated with distinct fold-in indices via lane position). With
    ``checkpoint_dir`` set, each bucket checkpoints per segment and resumes
    after interruption.

    Returns:
        {residue: (mcweights (chains, S, K), mcrates (chains, S, K))}
    """
    # residues with no events are omitted, matching the reference's
    # '.dataset_too_small' skip sentinel (scripts/get_rerun_residues.py:23-34)
    nonempty = {name: t for name, t in times_per_residue.items()
                if len(t) > 0}
    expanded = {}
    for name, t in nonempty.items():
        for ch in range(n_chains):
            expanded[f"{name}#{ch}"] = t
    out: Dict[str, list] = {name: [None] * n_chains for name in nonempty}
    kwargs["engine"] = resolve_engine(kwargs.get("engine", "xla"),
                                      kwargs.get("interpret", False))
    # one-deep pipeline: dispatch bucket i+1's segments (async), then
    # finalize bucket i while the device works on i+1. Bucket i's results
    # stream back under compute, but at most one bucket's thinned samples
    # are deferred on device at a time — deferring ALL buckets to the end
    # would hold every bucket's sample buffers in device memory at once.
    # (With checkpointing the per-segment syncs dominate and the deferral
    # is a no-op.)
    kwargs.pop("defer_transfer", None)   # pipelining is managed here
    results, prev = [], None
    for batch in bucket_residues(expanded):
        ckpt = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            ckpt = os.path.join(
                checkpoint_dir, f"ckpt_{_checkpoint_key(batch, cfg)}.npz")
        cur = run_batch(batch, cfg, checkpoint_path=ckpt,
                        defer_transfer=True, **kwargs)
        if prev is not None:
            results.append(finalize_batch(prev))
        prev = cur
    if prev is not None:
        results.append(finalize_batch(prev))
    for res in results:
        for i, lane_name in enumerate(res.names):
            name, ch = lane_name.rsplit("#", 1)
            out[name][int(ch)] = (res.mcweights[i], res.mcrates[i])
    return {name: (np.stack([w for w, _ in chains]),
                   np.stack([r for _, r in chains]))
            for name, chains in out.items()}
