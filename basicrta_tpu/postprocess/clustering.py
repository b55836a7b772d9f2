"""Posterior-sample clustering and per-event membership probabilities.

Reproduces the observable pipeline of the reference's ``Gibbs.cluster`` /
``Gibbs.process_gibbs`` (gibbs.py:221-308) and the label re-sorting of
``mixture_and_plot`` (util.py:744-756):

1. discard burn-in, keep (weight, rate) samples with weight above
   ``wcutoff = 10/N`` (gibbs.py:284-291),
2. ``lmode`` = modal number of surviving components per sample
   (gibbs.py:293-294),
3. fit a GMM on log(weight, rate) pairs of "train" samples (those with
   exactly lmode survivors), predict labels for all survivors
   (gibbs.py:243-257),
4. per-event cluster-membership probabilities by voting each event's sampled
   component through the label map (gibbs.py:259-272) — here accumulated on
   device at unique-value granularity without materializing the (S, N)
   indicator,
5. relabel clusters by decreasing mean rate with noise clusters (membership
   max < noise_cutoff) last (util.py:744-756).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.postprocess.gmm import gmm_fit_predict


def component_counts(weights: np.ndarray, wcutoff: float) -> np.ndarray:
    """Number of components above the weight cutoff in each sample row."""
    return np.count_nonzero(np.asarray(weights) > wcutoff, axis=-1)


def select_lmode(lens: np.ndarray) -> int:
    """Modal surviving-component count (ties -> smallest, as scipy's mode)."""
    return int(np.bincount(lens).argmax())


def gather_cluster_data(weights: np.ndarray, rates: np.ndarray,
                        wcutoff: float, lmode: int):
    """Split post-burn-in samples into all/train (weight, rate) pair sets.

    Args:
        weights, rates: (S', K) post-burn-in thinned samples.
    Returns:
        data (M, 2): all above-cutoff (weight, rate) pairs, row-major in
            (sample, component) order — the reference's ``np.where`` layout.
        inds: tuple of (sample_idx (M,), comp_idx (M,)).
        train (Mt, 2): pairs from samples with exactly ``lmode`` survivors.
    """
    weights = np.asarray(weights)
    rates = np.asarray(rates)
    above = weights > wcutoff
    inds = np.where(above)
    data = np.stack((weights[inds], rates[inds]), axis=1)

    lens = above.sum(axis=1)
    train_rows = lens == lmode
    tmask = above[train_rows]
    train = np.stack((weights[train_rows][tmask],
                      rates[train_rows][tmask]), axis=1)
    return data, inds, train


@dataclasses.dataclass
class ClusterResult:
    """Output of :func:`cluster_samples`."""
    lmode: int                       # number of clusters
    labels: np.ndarray               # (M,) cluster label per surviving pair
    inds: Tuple[np.ndarray, np.ndarray]  # (sample, component) of each pair
    data: np.ndarray                 # (M, 2) surviving (weight, rate) pairs
    pindicator_values: Optional[np.ndarray] = None  # (V, lmode) row-stochastic
    presorts: Optional[np.ndarray] = None  # original label of sorted slot


def cluster_samples(key, weights_post: np.ndarray, rates_post: np.ndarray,
                    cfg: GibbsConfig, n_events: int) -> ClusterResult:
    """Steps 1-3: survivor filtering, lmode selection, GMM labeling."""
    wcutoff = cfg.wcutoff(n_events)
    lens = component_counts(weights_post, wcutoff)
    lmode = select_lmode(lens)
    data, inds, train = gather_cluster_data(weights_post, rates_post,
                                            wcutoff, lmode)
    labels, _ = gmm_fit_predict(
        key, jnp.log(jnp.asarray(train)), jnp.log(jnp.asarray(data)),
        n_components=lmode, n_init=cfg.gmm_n_init, max_iter=cfg.gmm_max_iter,
        tol=cfg.gmm_tol)
    return ClusterResult(lmode=lmode, labels=np.asarray(labels), inds=inds,
                         data=data)


def _label_matrix(inds, labels, shape) -> np.ndarray:
    """(S', K) matrix of cluster labels, -1 where weight <= wcutoff."""
    L = np.full(shape, -1, dtype=np.int32)
    L[inds] = labels
    return L


@functools.partial(jax.jit, static_argnames=("n_clusters", "tiers"))
def _votes_scan(key, W, R, values, counts, L, n_clusters: int,
                tiers: Optional[Tuple[int, int]] = None) -> jax.Array:
    """Device core of the vote accumulation: scan over the S saved samples,
    drawing per-value component counts and accumulating them into the
    cluster of each above-cutoff component. Keeps only the (V, C)
    accumulator live. ``tiers`` (static) enables the multiplicity-tiered
    multinomial — value columns must then be sorted by count descending."""
    from basicrta_tpu.sampler.kernels import _tiered_multinomial
    S = W.shape[0]

    def step(votes, xs):
        key_j, w, r, lab = xs
        logz = (jnp.log(w)[None, :] + jnp.log(r)[None, :]
                - values[:, None] * r[None, :])
        m = _tiered_multinomial(key_j, counts,
                                jax.nn.softmax(logz, axis=-1), tiers)
        onehot = jax.nn.one_hot(lab, n_clusters, dtype=m.dtype)  # -1 -> 0
        return votes + jnp.matmul(
            m, onehot, precision=jax.lax.Precision.HIGHEST), None

    keys = jax.random.split(key, S)
    votes0 = jnp.zeros((values.shape[0], n_clusters), jnp.float32)
    votes, _ = jax.lax.scan(step, votes0, (keys, W, R, L))
    return votes


def accumulate_cluster_votes(key, weights_post, rates_post, values, counts,
                             label_matrix, n_clusters: int) -> np.ndarray:
    """Per-unique-value cluster vote totals, shape (V, n_clusters).

    For each saved posterior sample, draw the per-value component counts
    ``m_v ~ Multinomial(c_v, z_v(w, r))`` (the reference's stored indicator
    regenerated conditionally, cf. gibbs.py:321-334) and add them to the
    cluster of each above-cutoff component (gibbs.py:264-272). Value columns
    are re-sorted by multiplicity so the tiered multinomial applies (same
    optimization as the sampler's hot loop); votes are returned in the
    caller's value order.
    """
    from basicrta_tpu.sampler.kernels import compute_tiers
    counts_np = np.asarray(counts, np.float64)
    order, tiers = compute_tiers(counts_np)
    values_s = jnp.asarray(np.asarray(values, np.float64)[order], jnp.float32)
    counts_s = jnp.asarray(counts_np[order], jnp.float32)
    W = jnp.asarray(weights_post, jnp.float32)
    R = jnp.asarray(rates_post, jnp.float32)
    L = jnp.asarray(label_matrix)
    votes_sorted = np.asarray(_votes_scan(key, W, R, values_s, counts_s, L,
                                          n_clusters, tiers))
    votes = np.empty_like(votes_sorted)
    votes[order] = votes_sorted
    return votes


def sort_labels_by_rate(result: ClusterResult,
                        noise_cutoff: float) -> ClusterResult:
    """Relabel clusters: non-noise by decreasing mean rate, noise last.

    Noise clusters are those whose per-event membership probability never
    exceeds ``noise_cutoff`` (reference util.py:744-756; gibbs.py:144).
    Mutates and returns ``result`` with sorted ``labels``,
    ``pindicator_values`` columns, and the ``presorts`` permutation
    (original label occupying each sorted slot, cf. gibbs.py:297-300).
    """
    labels = result.labels
    arates = result.data[:, 1]
    pind = result.pindicator_values
    all_clusters = np.arange(pind.shape[1])
    present = np.isin(all_clusters, np.unique(labels))

    imaxs = pind.max(axis=0)
    # empty clusters (possible when the GMM predict assigns nothing to a
    # component) have no rate mean and effectively zero membership; treat
    # them as noise so indexing stays by label value, never by position
    noise_mask = (imaxs < noise_cutoff) | ~present
    means = np.array([arates[labels == i].mean() if present[i] else -np.inf
                      for i in all_clusters])

    non_noise = all_clusters[~noise_mask]
    noise = all_clusters[noise_mask]
    vsorts = means[non_noise].argsort()[::-1]
    nsorts = means[noise].argsort()[::-1]
    presorts = np.concatenate([non_noise[vsorts], noise[nsorts]]).astype(int)
    sorts = np.empty(len(all_clusters), dtype=int)
    sorts[presorts] = np.arange(len(all_clusters))

    result.labels = sorts[labels]
    result.pindicator_values = pind[:, presorts]
    result.presorts = presorts
    return result


def process_samples(key, mcweights, mcrates, values, counts,
                    cfg: GibbsConfig) -> ClusterResult:
    """Full post-processing: filter -> lmode -> GMM -> votes -> sort.

    The device-side analogue of ``Gibbs.process_gibbs`` (gibbs.py:275-308)
    minus plotting and parameter estimation (see ``postprocess.tau``).
    """
    kg, kv = jax.random.split(jax.random.key(cfg.seed) if key is None else key)
    n_events = int(np.asarray(counts).sum())
    b = cfg.burnin_samples
    if b >= len(mcweights):
        raise ValueError(
            f"burn-in discards all samples ({b} thinned samples of burn-in "
            f"vs {len(mcweights)} collected); lower cfg.burnin or raise "
            f"cfg.niter")
    W = np.asarray(mcweights)[b:]
    R = np.asarray(mcrates)[b:]
    res = cluster_samples(kg, W, R, cfg, n_events)
    L = _label_matrix(res.inds, res.labels, W.shape)
    votes = accumulate_cluster_votes(kv, W, R, values, counts, L, res.lmode)
    denom = votes.sum(axis=1, keepdims=True)
    res.pindicator_values = votes / np.maximum(denom, 1e-30)
    return sort_labels_by_rate(res, cfg.noise_cutoff)
