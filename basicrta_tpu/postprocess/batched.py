"""Batched cross-residue posterior processing.

The reference re-processes residues one at a time in an OS pool
(reference cluster.py:54-76); a per-residue port of that shape would
re-jit the GMM for every residue's distinct (sample-count, lmode)
signature — a fresh XLA compile per residue, which would dominate a
full-protein run. Here residues are bucketed by (lmode, padded sizes), padding is masked
through the GMM's ``train_weights`` hook, and each bucket runs as ONE
vmapped device program: one compile per bucket signature, every residue in
the bucket processed in parallel on the device.

Statistical semantics per residue are unchanged from
``clustering.process_samples`` (reference gibbs.py:275-308): burn-in and
weight-cutoff filtering, modal surviving-component count, GMM labeling of
log(weight, rate) pairs, indicator votes, rate-sorted relabeling.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.postprocess.clustering import (ClusterResult,
                                                 _label_matrix,
                                                 component_counts,
                                                 gather_cluster_data,
                                                 select_lmode,
                                                 sort_labels_by_rate)
from basicrta_tpu.postprocess.gmm import gmm_fit_predict
from basicrta_tpu.sampler.batch import _next_pow2
from basicrta_tpu.sampler.kernels import _tiered_multinomial, compute_tiers


def _put(a, sharding):
    """jnp array, laid out by ``sharding`` when one is given."""
    a = jnp.asarray(a)
    return jax.device_put(a, sharding) if sharding is not None else a


def _pad_size(n: int, floor: int = 128, step: int = 4) -> int:
    """Geometric pad ladder. Coarser than pow2 (default 4x steps) so a
    protein's residues land in a handful of compile signatures instead of
    one per size class; EM/vote cost is linear in rows, so the bounded
    padding waste is much cheaper than the avoided XLA compiles."""
    return _next_pow2(n, floor=floor, step=step)


@functools.partial(jax.jit, static_argnames=("lmode", "n_init", "max_iter"))
def _gmm_bucket_core(keys, train, train_w, data, lmode: int, n_init: int,
                     max_iter: int, tol: float):
    fit = jax.vmap(lambda k, tr, tw, da: gmm_fit_predict(
        k, tr, da, n_components=lmode, n_init=n_init,
        max_iter=max_iter, tol=tol, train_weights=tw)[0])
    return fit(keys, train, train_w, data)


def _gmm_bucket(keys, train, train_w, data, lmode: int, cfg: GibbsConfig):
    """One vmapped GMM fit+predict over a bucket of residues sharing
    (lmode, padded shapes). Padded train rows carry zero weight; labels of
    padded data rows are sliced off by the caller. The jitted core lives at
    module level so repeated buckets with the same signature reuse one
    compilation."""
    return _gmm_bucket_core(keys, train, train_w, data, lmode=lmode,
                            n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
                            tol=cfg.gmm_tol)


@functools.partial(jax.jit, static_argnames=("n_clusters", "tiers"))
def _votes_bucket_core(keys, W, R, values, counts, L, n_clusters: int,
                       tiers: Optional[Tuple[int, int]]):
    def one(key, w_s, r_s, v, c, lab):
        S = w_s.shape[0]
        # chunk the sample axis: the S multinomial draws are independent
        # given their per-sample keys, so CH of them batch into one
        # vmapped call per scan step — 1/CH the serial steps of a scan
        # that is latency-bound on small (V, K) tiles. The vote
        # accumulation stays in original sample order (the fori below)
        # and per-sample keys are unchanged, so results are bitwise identical to the unchunked
        # scan (tests/test_postprocess_batched). Whole-batch CH = S
        # unless the multinomial's (terms, CH, V) inversion tables would
        # get large; then the largest divisor <= 32.
        if S * v.shape[0] <= 4_000_000:
            CH = S
        else:
            CH = 1
            for cand in (32, 30, 24, 20, 18, 16, 15, 12, 10, 9, 8, 6, 5,
                         4, 3, 2):
                if S % cand == 0:
                    CH = cand
                    break

        def draw(key_j, w, r, lb):
            logz = (jnp.log(w)[None, :] + jnp.log(r)[None, :]
                    - v[:, None] * r[None, :])
            m = _tiered_multinomial(key_j, c, jax.nn.softmax(logz, axis=-1),
                                    tiers)
            onehot = jax.nn.one_hot(lb, n_clusters, dtype=m.dtype)
            return jnp.matmul(m, onehot, precision=jax.lax.Precision.HIGHEST)

        def step(votes, xs):
            key_j, w, r, lb = xs
            mv = jax.vmap(draw)(key_j, w, r, lb)          # (CH, V, L)
            votes = jax.lax.fori_loop(
                0, CH, lambda j, acc: acc + mv[j], votes)
            return votes, None

        sub = jax.random.split(key, S)
        votes0 = jnp.zeros((v.shape[0], n_clusters), jnp.float32)
        chunk = lambda a: a.reshape((S // CH, CH) + a.shape[1:])  # noqa: E731
        votes, _ = jax.lax.scan(step, votes0,
                                (chunk(sub), chunk(w_s), chunk(r_s),
                                 chunk(lab)))
        return votes

    return jax.vmap(one)(keys, W, R, values, counts, L)


def _n_shards0(sharding) -> int:
    """Device count along the leading (residue) axis of a NamedSharding."""
    if sharding is None or not sharding.spec:
        return 1
    spec0 = sharding.spec[0]
    if spec0 is None:
        return 1
    axes = (spec0,) if isinstance(spec0, str) else tuple(spec0)
    return int(np.prod([sharding.mesh.shape[a] for a in axes]))


def _lane_target(Bk: int, n_shards: int) -> int:
    """Quantized lane count: next power of two (floor 8), rounded up to a
    multiple of the shard count. The lane count is part of every XLA
    compile signature — without quantization each protein's bucket sizes
    force a fresh compile of every bucket program (~80 s of compiles for a
    50-residue protein); padded lanes replicate lane 0 and cost only
    linear compute."""
    return -(-_next_pow2(Bk, floor=8) // n_shards) * n_shards


def _pad_lanes(arrs, target: int):
    """Pad each array's leading axis up to ``target`` lanes by replicating
    the first lane (results are sliced back by the caller)."""
    Bk = arrs[0].shape[0]
    pad = target - Bk
    if pad <= 0:
        return arrs
    out = []
    for a in arrs:
        first = a[:1]
        reps = jnp.repeat if isinstance(a, jax.Array) else np.repeat
        cat = jnp.concatenate if isinstance(a, jax.Array) else np.concatenate
        out.append(cat([a, reps(first, pad, axis=0)], axis=0))
    return out


def _quantize_tier(n: int, cap: int) -> int:
    """Round a tier boundary up to a power of two (floor 16) so compile
    keys coalesce across buckets; rounding UP only moves columns into a
    heavier (always-correct) sampler tier."""
    return min(_next_pow2(n, floor=16), cap) if n > 0 else 0


def _votes_bucket_async(keys, W, R, values, counts, L, n_clusters: int,
                        sharding=None):
    """Dispatch one bucket's vote program; returns (device votes, order)
    for :func:`_votes_bucket_collect` — split so callers can dispatch
    every bucket before syncing any (stage pipelining in
    process_residues_batched)."""
    counts_np = np.asarray(counts, np.float64)
    order, (head_end, single_start) = compute_tiers(counts_np)
    V_p = counts_np.shape[-1]
    head_end = _quantize_tier(head_end, V_p)
    single_start = max(_quantize_tier(single_start, V_p), head_end)
    values_s = np.take_along_axis(np.asarray(values, np.float64), order, -1)
    counts_s = np.take_along_axis(counts_np, order, -1)
    dev = _votes_bucket_core(
        _put(keys, sharding), _put(W, sharding), _put(R, sharding),
        _put(jnp.asarray(values_s, jnp.float32), sharding),
        _put(jnp.asarray(counts_s, jnp.float32), sharding),
        _put(L, sharding), n_clusters, (head_end, single_start))
    return dev, order


def _votes_bucket_collect(dev, order):
    votes_s = np.asarray(dev)
    votes = np.empty_like(votes_s)
    np.put_along_axis(votes, order[..., None], votes_s, axis=1)
    return votes


def _votes_bucket(keys, W, R, values, counts, L, n_clusters: int,
                  sharding=None):
    """Vmapped per-residue vote accumulation (clustering
    accumulate_cluster_votes semantics); padded value columns carry zero
    counts and contribute nothing. Value columns are re-sorted per lane by
    multiplicity descending so the tiered multinomial applies — the same
    skew exploitation as the sampler hot loop — with shared (max-over-lane)
    tier boundaries quantized for compile-key reuse. ``sharding`` splits
    the residue axis over a device mesh (collective-free)."""
    return _votes_bucket_collect(
        *_votes_bucket_async(keys, W, R, values, counts, L, n_clusters,
                             sharding))


def select_chain(mcweights: np.ndarray, mcrates: np.ndarray, chain,
                 burnin_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror Gibbs.process_gibbs chain selection: an index, or 'pooled' to
    concatenate post-burn-in samples of all chains behind one burn-in-sized
    prefix."""
    if chain == "pooled" and mcweights.shape[0] > 1:
        b = burnin_samples
        W = np.concatenate([mcweights[0][:b]] + [c[b:] for c in mcweights])
        R = np.concatenate([mcrates[0][:b]] + [c[b:] for c in mcrates])
        return W, R
    idx = 0 if chain == "pooled" else chain
    return mcweights[idx], mcrates[idx]


def process_residues_batched(
        items: Dict[str, tuple], cfg: GibbsConfig,
        chain=0, progress_cb=None,
        sharding=None, timings=None) -> Dict[str, ClusterResult]:
    """Post-process many residues' chains with bucketed device batching.

    Args:
        items: {residue: (mcweights (chains,S,K), mcrates, values (V,),
            counts (V,))} — the sampler outputs plus each residue's
            deduplicated times.
        chain: chain index or 'pooled' (cf. Gibbs.process_gibbs).
        sharding: optional ``NamedSharding`` splitting the leading residue
            axis over a device mesh (see ``parallel.mesh.lane_sharding``).
            Residues are independent, so every bucket program partitions
            collective-free; lanes are padded to the shard count.

    Returns:
        {residue: ClusterResult} (sorted labels, pindicator, presorts).

    ``timings``: optional dict; filled with per-stage wall seconds
    (host_prep_s / gmm_s / votes_s / finish_s, device work synced at
    stage boundaries) for the warm-path attribution behind BENCH's
    ``post_warm_s_per_residue`` (scripts/postbench.py).
    """
    import time as _time
    t_mark = _time.time() if timings is not None else 0.0

    def _lap(key):
        nonlocal t_mark
        if timings is not None:
            now = _time.time()
            timings[key] = timings.get(key, 0.0) + (now - t_mark)
            t_mark = now

    n_shards = _n_shards0(sharding)
    b = cfg.burnin_samples
    prepared = {}
    for name, (mcw, mcr, values, counts) in items.items():
        W, R = select_chain(np.asarray(mcw), np.asarray(mcr), chain, b)
        if b >= len(W):
            raise ValueError(
                f"burn-in discards all samples for {name} ({b} thinned "
                f"burn-in vs {len(W)} collected)")
        W, R = W[b:], R[b:]
        n_events = int(np.asarray(counts).sum())
        wcutoff = cfg.wcutoff(n_events)
        lmode = select_lmode(component_counts(W, wcutoff))
        data, inds, train = gather_cluster_data(W, R, wcutoff, lmode)
        prepared[name] = dict(W=W, R=R, values=np.asarray(values),
                              counts=np.asarray(counts), lmode=lmode,
                              data=data, inds=inds, train=train)

    _lap("host_prep_s")
    # ---- stage 1: bucketed GMM fits ---------------------------------- #
    buckets: Dict[tuple, list] = {}
    for name, p in prepared.items():
        key = (p["lmode"], _pad_size(len(p["train"])),
               _pad_size(len(p["data"])))
        buckets.setdefault(key, []).append(name)

    base_key = jax.random.key(cfg.seed + 1)
    import zlib

    # derive every residue's per-stage key in ONE vmapped fold_in per
    # salt: the per-residue scalar fold_in calls were ~256 tiny device
    # dispatches per protein, each a host round-trip.
    # fold_in under vmap computes the identical key values.
    all_names = list(prepared)
    _name_ix = {n: i for i, n in enumerate(all_names)}
    crcs = jnp.asarray([zlib.crc32(str(n).encode()) & 0x7FFFFFFF
                        for n in all_names], jnp.uint32)
    _keys_by_salt = {
        salt: jax.vmap(lambda c, s=salt: jax.random.fold_in(
            jax.random.fold_in(base_key, s), c))(crcs)
        for salt in (0, 1)}

    def residue_keys(names, salt=0):
        return _keys_by_salt[salt][
            np.asarray([_name_ix[n] for n in names])]

    done = 0
    total = 2 * len(prepared)
    # dispatch every bucket program before syncing any: per-bucket device
    # round-trips overlap once dispatched (schedule-only; results
    # unchanged)
    pending = []
    for (lmode, Mt_p, M_p), names in buckets.items():
        Bk = len(names)
        train = np.zeros((Bk, Mt_p, 2), np.float64)
        train_w = np.zeros((Bk, Mt_p), np.float32)
        data = np.ones((Bk, M_p, 2), np.float64)
        for i, name in enumerate(names):
            p = prepared[name]
            train[i, :len(p["train"])] = np.log(p["train"])
            train[i, len(p["train"]):] = train[i, 0]  # benign pad location
            train_w[i, :len(p["train"])] = 1.0
            data[i, :len(p["data"])] = np.log(p["data"])
        keys = residue_keys(names)
        keys, train, train_w, data = _pad_lanes(
            [keys, train, train_w, data], _lane_target(Bk, n_shards))
        pending.append((names, Bk, _gmm_bucket(
            _put(keys, sharding), _put(train, sharding),
            _put(train_w, sharding), _put(data, sharding),
            lmode, cfg)))
    for names, Bk, dev in pending:
        labels = np.asarray(dev)[:Bk]
        for i, name in enumerate(names):
            p = prepared[name]
            p["labels"] = labels[i, :len(p["data"])].astype(np.int32)
            done += 1
        if progress_cb is not None:
            progress_cb(done, total)

    _lap("gmm_s")
    # ---- stage 2: bucketed vote accumulation -------------------------- #
    # residues of DIFFERENT lmode share one vote program: the one-hot /
    # vote matrix is built at the full static width K and each residue's
    # columns [:lmode] sliced out afterwards — label values never reach
    # lmode, so the extra columns accumulate exactly zero and every kept
    # column's arithmetic is unchanged. This collapses ~#lmodes x
    # #shapes vote buckets to #shapes — each avoided bucket was a full
    # program dispatch.
    vbuckets: Dict[tuple, list] = {}
    for name, p in prepared.items():
        key = (_pad_size(len(p["values"])), p["W"].shape)
        vbuckets.setdefault(key, []).append(name)

    K_full = cfg.ncomp
    results: Dict[str, ClusterResult] = {}
    vpending = []
    for (V_p, w_shape), names in vbuckets.items():
        Bk = len(names)
        S, K = w_shape
        Wb = np.empty((Bk, S, K), np.float32)
        Rb = np.empty((Bk, S, K), np.float32)
        Vb = np.ones((Bk, V_p), np.float32)
        Cb = np.zeros((Bk, V_p), np.float32)
        Lb = np.empty((Bk, S, K), np.int32)
        for i, name in enumerate(names):
            p = prepared[name]
            Wb[i], Rb[i] = p["W"], p["R"]
            Vb[i, :len(p["values"])] = p["values"]
            Cb[i, :len(p["counts"])] = p["counts"]
            Lb[i] = _label_matrix(p["inds"], p["labels"], (S, K))
        keys = residue_keys(names, salt=1)
        keys, Wb, Rb, Vb, Cb, Lb = _pad_lanes([keys, Wb, Rb, Vb, Cb, Lb],
                                              _lane_target(Bk, n_shards))
        vpending.append((names, Bk, _votes_bucket_async(
            keys, Wb, Rb, Vb, Cb, Lb, K_full, sharding=sharding)))
    for names, Bk, (dev, order) in vpending:
        votes = _votes_bucket_collect(dev, order)[:Bk]
        _lap("votes_s")
        for i, name in enumerate(names):
            p = prepared[name]
            v = votes[i, :len(p["values"]), :p["lmode"]]
            denom = v.sum(axis=1, keepdims=True)
            res = ClusterResult(lmode=p["lmode"], labels=p["labels"],
                                inds=p["inds"], data=p["data"])
            res.pindicator_values = v / np.maximum(denom, 1e-30)
            results[name] = sort_labels_by_rate(res, cfg.noise_cutoff)
            done += 1
        if progress_cb is not None:
            progress_cb(done, total)
        _lap("finish_s")
    return results
