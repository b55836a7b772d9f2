"""Full-covariance Gaussian-mixture EM in JAX with vmapped restarts.

Replaces the reference's ``sklearn.mixture.GaussianMixture(n_init=117, ...)``
call (reference gibbs.py:229-257, 296). The reference runs 117 sequential
C-implemented EM fits; here the restarts are a ``vmap`` axis, so all 117 fits
run as one fused device program and the best lower bound wins. Initialization
is kmeans++ seeding plus a few Lloyd iterations per restart (sklearn's
default init is a full k-means; with 117 restarts the abbreviated variant is
statistically equivalent — the selection over restarts dominates).

Supports per-sample weights so padded batches can be clustered without
recompilation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# f32 products of data run at full precision (a GPU would otherwise use
# TF32 and keep about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST


class GMMParams(NamedTuple):
    means: jax.Array       # (C, D)
    chols: jax.Array       # (C, D, D) Cholesky factors of covariances
    log_weights: jax.Array  # (C,)
    lower_bound: jax.Array  # () final mean log-likelihood


def _component_log_prob(X, means, chols):
    """Log N(x | mu_c, Sigma_c) for all points/components: (N, C)."""
    D = X.shape[-1]
    diff = X[:, None, :] - means[None, :, :]                     # (N, C, D)
    # Solve L y = diff  ->  y = L^-1 diff; mahalanobis = |y|^2
    y = jax.vmap(
        lambda Lc, dc: jax.scipy.linalg.solve_triangular(Lc, dc.T, lower=True),
        in_axes=(0, 1))(chols, diff)                              # (C, D, N)
    maha = jnp.sum(y ** 2, axis=1).T                              # (N, C)
    logdet = jnp.sum(jnp.log(jnp.diagonal(chols, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (maha + D * jnp.log(2 * jnp.pi)) - logdet[None, :]


def _kmeanspp_init(key, X, sw, n_components, lloyd_iters=10):
    """kmeans++ seeding + Lloyd refinement; returns centers (C, D).

    Schedule notes (both bitwise-identical to the original
    full-matrix formulation, tests/test_gmm.py):

    - seeding carries the running min distance-to-chosen-centers and
      updates it against only the NEWEST center per step — O(C N)
      instead of O(C^2 N); min is associative/exact, and the per-center
      distances are computed by the same expression.
    - Lloyd runs as a while_loop that freezes once the assignment stops
      changing (the center update is then a fixed point, so further
      iterations were already no-ops); under the restart vmap it exits
      when EVERY restart's assignment has settled.
    """
    N = X.shape[0]
    k0, key = jax.random.split(key)
    first = jax.random.choice(k0, N, p=sw / jnp.sum(sw))
    centers0 = jnp.tile(X[first], (n_components, 1))
    d2min0 = jnp.sum((X - X[first][None, :]) ** 2, axis=-1)       # (N,)

    def seed_step(carry, key_c):
        centers, d2min, c_idx = carry
        p = sw * d2min
        p = jnp.where(jnp.isfinite(p), p, 0.0)
        nxt = jax.random.choice(key_c, N, p=p / jnp.maximum(jnp.sum(p), 1e-30))
        centers = centers.at[c_idx].set(X[nxt])
        d2new = jnp.sum((X - X[nxt][None, :]) ** 2, axis=-1)
        return (centers, jnp.minimum(d2min, d2new), c_idx + 1), None

    keys = jax.random.split(key, n_components - 1)
    (centers, _, _), _ = jax.lax.scan(seed_step, (centers0, d2min0, 1),
                                      keys)

    def lloyd_body(carry):
        i, centers, prev_assign, _ = carry
        d2 = jnp.sum((X[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, n_components, dtype=X.dtype)
        onehot = onehot * sw[:, None]
        Nk = jnp.maximum(jnp.sum(onehot, axis=0), 1e-12)
        new = jnp.matmul(onehot.T, X, precision=_HIGHEST) / Nk[:, None]
        # keep old center for empty clusters
        new = jnp.where(jnp.sum(onehot, axis=0)[:, None] > 0, new, centers)
        return i + 1, new, assign, jnp.all(assign == prev_assign)

    init = (jnp.asarray(0, jnp.int32), centers,
            jnp.full((N,), -1, jnp.int32), jnp.asarray(False))
    _, centers, _, _ = jax.lax.while_loop(
        lambda c: (c[0] < lloyd_iters) & ~c[-1], lloyd_body, init)
    return centers


def _m_step(X, sw, resp, reg_covar):
    """Weighted M-step; returns (means, chols, log_weights)."""
    D = X.shape[-1]
    wresp = resp * sw[:, None]                                    # (N, C)
    Nk = jnp.maximum(jnp.sum(wresp, axis=0), 10 * jnp.finfo(X.dtype).eps)
    means = jnp.matmul(wresp.T, X, precision=_HIGHEST) / Nk[:, None]
    diff = X[:, None, :] - means[None, :, :]                      # (N, C, D)
    covs = jnp.einsum("nc,ncd,nce->cde", wresp, diff, diff,
                      precision=_HIGHEST) / Nk[:, None, None]
    covs = covs + reg_covar * jnp.eye(D, dtype=X.dtype)[None]
    chols = jnp.linalg.cholesky(covs)
    log_w = jnp.log(Nk / jnp.sum(Nk))
    return means, chols, log_w


def _em_single(key, X, sw, n_components, max_iter, tol, reg_covar):
    """One EM restart with convergence freezing; returns GMMParams."""
    centers = _kmeanspp_init(key, X, sw, n_components)
    # one-hot responsibilities from the kmeans assignment seed the first M-step
    d2 = jnp.sum((X[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    resp0 = jax.nn.one_hot(jnp.argmin(d2, axis=1), n_components, dtype=X.dtype)
    means, chols, log_w = _m_step(X, sw, resp0, reg_covar)
    total_w = jnp.sum(sw)

    def em_iter(carry):
        i, means, chols, log_w, prev_lb, done = carry
        logp = _component_log_prob(X, means, chols) + log_w[None, :]
        lse = jax.scipy.special.logsumexp(logp, axis=1)
        lb = jnp.sum(sw * lse) / total_w
        resp = jnp.exp(logp - lse[:, None])
        n_means, n_chols, n_log_w = _m_step(X, sw, resp, reg_covar)
        # a NaN lower bound also ends the restart: NaN propagates (every
        # later iteration stays NaN) and the final NaN maps to -inf below,
        # so the restart can never win the argmax — continuing to
        # max_iter only forced the WHOLE vmapped bucket to keep
        # iterating for a loser (round-5: one degenerate restart dragged
        # every bucket to the 100-iteration cap; labels are identical as
        # long as any restart converges finite, which non-degenerate
        # data always provides)
        now_done = done | (jnp.abs(lb - prev_lb) < tol) | jnp.isnan(lb)
        keep = lambda new, old: jnp.where(done, old, new)
        return (i + 1, keep(n_means, means), keep(n_chols, chols),
                keep(n_log_w, log_w), jnp.where(done, prev_lb, lb),
                now_done)

    # while_loop instead of a fixed-length scan: the freeze logic above
    # makes post-convergence iterations pure no-ops, so exiting early is
    # bitwise identical — and under vmap the loop runs only until EVERY
    # restart in the batch has converged or gone NaN. Measured on the
    # canonical post-processing workload the restarts' EM typically
    # converges far before sklearn's max_iter=100 parity bound, and the
    # GMM stage is ~70% of warm post-processing time (design.md).
    init = (jnp.asarray(0, jnp.int32), means, chols, log_w,
            jnp.asarray(-jnp.inf, X.dtype), jnp.asarray(False))
    (_, means, chols, log_w, lb, _) = jax.lax.while_loop(
        lambda c: (c[0] < max_iter) & ~c[-1], em_iter, init)
    lb = jnp.where(jnp.isnan(lb), -jnp.inf, lb)
    return GMMParams(means, chols, log_w, lb)


@functools.partial(jax.jit, static_argnames=("n_components", "n_init",
                                             "max_iter"))
def gmm_fit_predict(key: jax.Array, train: jax.Array, data: jax.Array,
                    n_components: int, n_init: int = 117,
                    max_iter: int = 100, tol: float = 1e-3,
                    reg_covar: float = 1e-6, train_weights=None):
    """Fit a full-covariance GMM on ``train`` and label ``data``.

    Mirrors the reference's fit-on-train / predict-on-all pattern
    (gibbs.py:255-257). All ``n_init`` restarts run under one vmap; the
    restart with the best weighted mean log-likelihood provides the labels.

    Returns:
        (labels (M,) int32, params GMMParams of the winning restart)
    """
    train = train.astype(jnp.float32)
    data = data.astype(jnp.float32)
    sw = (jnp.ones(train.shape[0], train.dtype) if train_weights is None
          else train_weights.astype(train.dtype))
    keys = jax.random.split(key, n_init)
    fits = jax.vmap(lambda k: _em_single(k, train, sw, n_components,
                                         max_iter, tol, reg_covar))(keys)
    best = jnp.argmax(fits.lower_bound)
    params = jax.tree.map(lambda a: a[best], fits)
    logp = (_component_log_prob(data, params.means, params.chols)
            + params.log_weights[None, :])
    return jnp.argmax(logp, axis=1).astype(jnp.int32), params
