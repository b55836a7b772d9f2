"""Branch-free samplers for Binomial, Gamma, and Dirichlet draws.

``jax.random.binomial`` / ``gamma`` are rejection samplers built on
data-dependent ``lax.while_loop``s, a fixed control-flow cost per call that
would dominate a Gibbs sweep whose element count is small (the collapsed
sampler draws a 15-step binomial chain over ~10^3 unique values per sweep,
110k times). These replacements run a *fixed* number of rejection rounds
as masked vector ops — no data-dependent control flow, so XLA compiles the
sweep into straight-line vector code.

Exactness: each sampler is the textbook exact algorithm (binomial inversion
via the PMF recurrence for n*p small, Hormann's BTRS transformed rejection
for n*p large, Marsaglia-Tsang for Gamma) with the rejection loop truncated
at a depth where the all-rounds-fail probability is < 1e-8 per draw; a
deterministic mode-fallback covers that event. The induced total-variation
error is orders of magnitude below f32 rounding and is validated by KS /
moment tests against scipy (tests/test_random.py).

References: Hormann (1993) "The generation of binomial random variates";
Marsaglia & Tsang (2000) "A simple method for generating gamma variables".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from basicrta_tpu.ops.precise import exp_f32, log_f32, stirling_tail

# Rejection-round depths. Acceptance per round: BTRS >= ~0.79, MT >= ~0.95.
_BTRS_ROUNDS = 12     # failure < (0.21)^12 ~ 7e-9
_MT_ROUNDS = 8        # failure < (0.05)^8 ~ 4e-11
_INV_TERMS = 64       # inversion covers n*p <= 10 out to +50 sigma


def _accept_first(body, init, rounds: int, unroll: bool):
    """Accept-first rejection loop. ``unroll=True`` emits straight-line code
    (fastest at small batch where loop latency dominates); ``unroll=False``
    compiles one round body inside ``fori_loop`` (10x faster compiles and
    better for large batches)."""
    if unroll:
        carry = init
        for r in range(rounds):
            carry = body(r, carry)
        return carry
    return jax.lax.fori_loop(0, rounds, body, init)


def _inversion_counts(u, n, p, terms: int, dtype):
    """CDF-inversion count from a *parallel* ``terms``-row PMF table.

    The PMF recurrence ``pmf_{k+1} = pmf_k (n-k)/(k+1) p/q`` is evaluated
    as a log-space cumsum over a (terms, ...) table instead of a
    sequential scan: two cumulative ops instead of ~terms dependent
    steps. Shared
    by :func:`_binomial_inversion` and :func:`binomial_small` so the
    precision-critical precise-log usage lives in ONE place.
    """
    tiny = jnp.finfo(dtype).tiny
    q = jnp.maximum(1.0 - p, tiny)
    # precise log/exp: an approximate native log/exp is amplified n-fold
    # by n*log(q) and scales the whole CDF (ops/precise.py)
    logpmf0 = n * log_f32(q)
    log_ratio = log_f32(jnp.maximum(p, tiny)) - log_f32(q)
    j = jnp.arange(terms - 1, dtype=dtype).reshape(
        (terms - 1,) + (1,) * n.ndim)
    # log step j -> j+1; -inf once k exceeds n (pmf identically 0)
    steps = jnp.where(n - j > 0,
                      log_f32(jnp.maximum(n - j, tiny)) - log_f32(j + 1.0)
                      + log_ratio,
                      -jnp.inf)
    logpmf = jnp.concatenate(
        [jnp.zeros((1,) + n.shape, dtype), jnp.cumsum(steps, axis=0)],
        axis=0) + logpmf0                                   # (terms, ...)
    cdf = jnp.cumsum(exp_f32(logpmf), axis=0)
    return jnp.sum((u[None] > cdf).astype(dtype), axis=0)


def _binomial_inversion(key, n, p, dtype):
    """Binomial via CDF inversion (:func:`_inversion_counts`).

    Exact for counts within the first ``_INV_TERMS`` PMF terms; used only
    when n*p <= 10, where the mass beyond 64 is < 1e-12.
    """
    u = jax.random.uniform(key, n.shape, dtype)
    m = _inversion_counts(u, n, p, _INV_TERMS, dtype)
    return jnp.minimum(m, n)


def _binomial_btrs(key, n, p, dtype, unroll=False):
    """Hormann's BTRS transformed-rejection binomial for n*p >= 10, p <= 0.5,
    with ``_BTRS_ROUNDS`` accept-first proposal rounds.

    The acceptance comparison uses Hormann 1993's BTRD regrouping of the
    log-PMF ratio: ``hb + (n+1) log(nm/nk) + (k+0.5) log(nk r / (k+1))
    - t(k) - t(n-k)`` with t the Stirling tail — algebraically identical
    to the lgamma form (checked to 1e-11 in f64, tests/test_pallas.py)
    but both per-round logs take near-unity ratio arguments, so the
    n-amplified terms carry small ABSOLUTE error and each round costs two
    precise logs + rational tails instead of two full Stirling lgammas."""
    tiny = jnp.finfo(dtype).tiny
    q = 1.0 - p
    spq = jnp.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = n * p + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    r_pq = jnp.maximum(p / jnp.maximum(q, tiny), tiny)
    m = jnp.floor((n + 1.0) * p)
    nm = n - m + 1.0
    hb = ((m + 0.5) * log_f32(jnp.maximum((m + 1.0) / (r_pq * nm), tiny))
          + stirling_tail(m) + stirling_tail(n - m))

    def round_body(r, carry):
        k_acc, done = carry
        kr = jax.random.fold_in(key, r)
        # separate keys per uniform keep draws prefix-stable under padding
        u = jax.random.uniform(kr, n.shape, dtype)
        v = jax.random.uniform(jax.random.fold_in(kr, 1), n.shape, dtype)
        u = u - 0.5
        us = 0.5 - jnp.abs(u)
        k = jnp.floor((2.0 * a / us + b) * u + c)
        in_range = (k >= 0) & (k <= n)
        fast = (us >= 0.07) & (v <= vr)
        # acceptance test (log of the scaled density ratio); vv is an
        # unamplified O(1)-absolute operand — native log suffices. Out-of-
        # range k makes the ratio args garbage (finite); in_range gates it.
        vv = jnp.log(jnp.maximum(v * alpha / (a / (us * us) + b), tiny))
        nk = n - k + 1.0
        slow = vv <= (hb + (n + 1.0) * log_f32(jnp.maximum(nm / nk, tiny))
                      + (k + 0.5)
                      * log_f32(jnp.maximum(nk * r_pq / (k + 1.0), tiny))
                      - stirling_tail(k) - stirling_tail(n - k))
        ok = in_range & (fast | slow)
        k_acc = jnp.where(done, k_acc, jnp.where(ok, k, k_acc))
        return k_acc, done | ok

    # all-rounds-fail (<1e-8): deterministic mode fallback via init=m
    k_acc, done = _accept_first(round_body, (m, jnp.zeros(n.shape, bool)),
                                _BTRS_ROUNDS, unroll)
    return k_acc


def binomial(key: jax.Array, n: jax.Array, p: jax.Array,
             dtype=jnp.float32, unroll: bool = False) -> jax.Array:
    """Exact Binomial(n, p) draws, branch-free, elementwise over broadcast
    shapes. Returns float counts (integer-valued)."""
    n = jnp.asarray(n, dtype)
    p = jnp.asarray(p, dtype)
    n, p = jnp.broadcast_arrays(n, p)
    p = jnp.clip(p, 0.0, 1.0)
    # symmetry: always sample with p' <= 0.5, flip the result back
    flip = p > 0.5
    p_eff = jnp.where(flip, 1.0 - p, p)
    small = n * p_eff <= 10.0

    k_inv, k_btrs = jax.random.split(key)
    # inversion path: degenerate-safe inputs for the inactive lanes
    m_inv = _binomial_inversion(k_inv, n, jnp.where(small, p_eff, 0.0), dtype)
    # btrs path: clamp inactive lanes into its domain
    n_b = jnp.where(small, 100.0, n)
    p_b = jnp.where(small, 0.3, p_eff)
    m_btrs = _binomial_btrs(k_btrs, n_b, p_b, dtype, unroll)

    m = jnp.where(small, m_inv, m_btrs)
    m = jnp.where(flip, n - m, m)
    m = jnp.where((p <= 0.0) | (n <= 0.0), 0.0, m)
    m = jnp.where(p >= 1.0, n, m)
    # upper bound through maximum(n, 0): clip with max < min would
    # return n itself, handing negative-n callers a negative "count"
    return jnp.clip(m, 0.0, jnp.maximum(n, 0.0))


def gamma(key: jax.Array, a: jax.Array, dtype=jnp.float32,
          unroll: bool = False) -> jax.Array:
    """Gamma(a, 1) draws via Marsaglia-Tsang with ``_MT_ROUNDS`` unrolled
    proposal rounds. Shapes a < 1 use the boost trick
    (Gamma(a) = Gamma(a+1) * U^(1/a))."""
    a = jnp.asarray(a, dtype)
    boost_mask = a < 1.0
    a_eff = jnp.where(boost_mask, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    kprop, kboost = jax.random.split(key)

    def round_body(r, carry):
        v_acc, done = carry
        kr = jax.random.fold_in(kprop, r)
        x = jax.random.normal(kr, a.shape, dtype)
        u = jax.random.uniform(jax.random.fold_in(kr, 1), a.shape, dtype,
                               minval=jnp.finfo(dtype).tiny)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (log_f32(u) < 0.5 * x * x + d - d * v
                        + d * log_f32(jnp.maximum(
                            v, jnp.finfo(dtype).tiny)))
        v_acc = jnp.where(done, v_acc, jnp.where(ok, v, v_acc))
        return v_acc, done | ok

    v_acc, _ = _accept_first(round_body,
                             (jnp.ones(a.shape, dtype),
                              jnp.zeros(a.shape, bool)),
                             _MT_ROUNDS, unroll)  # fallback: mode
    sample = d * v_acc

    ub = jax.random.uniform(kboost, a.shape, dtype,
                            minval=jnp.finfo(dtype).tiny)
    boosted = sample * exp_f32(log_f32(ub) / jnp.maximum(a, 1e-30))
    out = jnp.where(boost_mask, boosted, sample)
    # very small shapes (e.g. the Dirichlet prior alpha = 1/K) legitimately
    # produce draws below f32 range; clamp to tiny so downstream logs are
    # finite (such components are numerically dead either way)
    return jnp.maximum(out, jnp.finfo(dtype).tiny)


def dirichlet(key: jax.Array, alpha: jax.Array, dtype=jnp.float32,
              unroll: bool = False) -> jax.Array:
    """Dirichlet(alpha) via normalized Gammas (last axis)."""
    g = gamma(key, alpha, dtype, unroll)
    g = jnp.maximum(g, jnp.finfo(dtype).tiny)
    return g / jnp.sum(g, axis=-1, keepdims=True)


def binomial_small(key: jax.Array, n: jax.Array, p: jax.Array, nmax: int,
                   dtype=jnp.float32) -> jax.Array:
    """Exact Binomial(n, p) for statically bounded n <= nmax.

    Pure CDF inversion with an (nmax+1)-term PMF table — complete support,
    no rejection rounds, far cheaper than the general sampler when the bound
    is small (the Gibbs tail tier uses nmax = kernels.SMALL_NMAX).
    """
    n = jnp.asarray(n, dtype)
    p = jnp.clip(jnp.asarray(p, dtype), 0.0, 1.0)
    n, p = jnp.broadcast_arrays(n, p)
    u = jax.random.uniform(key, n.shape, dtype)
    m = _inversion_counts(u, n, p, nmax + 1, dtype)
    m = jnp.where(p >= 1.0, n, m)
    return jnp.clip(m, 0.0, jnp.maximum(n, 0.0))


def _multinomial_chain(key, n, probs, binom, dtype, unroll=False):
    """Conditional-binomial chain m_k ~ Bin(rem, p_k / suffix_k).

    With ``unroll=False`` the chain is a ``lax.scan`` over components so the
    compiled graph contains one binomial body, not K; ``unroll=True`` emits
    straight-line code for latency-bound small batches. The chain is
    inherently sequential either way.
    """
    K = probs.shape[-1]
    suffix = jnp.cumsum(probs[..., ::-1], axis=-1)[..., ::-1]
    rem = jnp.asarray(n, dtype)
    keys = jax.random.split(key, K - 1)
    pconds = jnp.clip(
        probs[..., :-1] / jnp.maximum(suffix[..., :-1],
                                      jnp.finfo(dtype).tiny), 0.0, 1.0)

    if unroll:
        out = []
        for k in range(K - 1):
            draw = binom(keys[k], rem, pconds[..., k])
            out.append(draw)
            rem = rem - draw
        out.append(rem)
        return jnp.stack(out, axis=-1)

    def step(rem, xs):
        key_k, pcond = xs
        draw = binom(key_k, rem, pcond)
        return rem - draw, draw

    rem, head = jax.lax.scan(step, rem,
                             (keys, jnp.moveaxis(pconds, -1, 0)))
    return jnp.concatenate([jnp.moveaxis(head, 0, -1), rem[..., None]],
                           axis=-1)


def multinomial(key: jax.Array, n: jax.Array, probs: jax.Array,
                dtype=jnp.float32, unroll: bool = False) -> jax.Array:
    """Exact Multinomial(n, probs) counts over the last axis via the
    conditional-binomial chain, each step branch-free.

    Args:
        n: (...,) trial counts.
        probs: (..., K) row-stochastic probabilities.
    Returns:
        (..., K) float counts summing to n.
    """
    return _multinomial_chain(
        key, n, probs, lambda k, r, p: binomial(k, r, p, dtype, unroll),
        dtype, unroll)


def multinomial_small(key: jax.Array, n: jax.Array, probs: jax.Array,
                      nmax: int, dtype=jnp.float32,
                      unroll: bool = False) -> jax.Array:
    """Exact Multinomial for statically bounded trial counts n <= nmax."""
    return _multinomial_chain(
        key, n, probs, lambda k, r, p: binomial_small(k, r, p, nmax, dtype),
        dtype, unroll)


def multinomial_single(key: jax.Array, n: jax.Array, probs: jax.Array,
                       dtype=jnp.float32) -> jax.Array:
    """Exact Multinomial for n in {0, 1}: one inverse-CDF categorical draw
    per row, scaled by n. The dominant tier for real residence-time data,
    where most unique values occur exactly once."""
    cdf = jnp.cumsum(probs, axis=-1)
    u = jax.random.uniform(key, n.shape, dtype)
    comp = jnp.sum((u[..., None] > cdf).astype(jnp.int32), axis=-1)
    K = probs.shape[-1]
    comp = jnp.minimum(comp, K - 1)
    return jax.nn.one_hot(comp, K, dtype=dtype) * n[..., None]
