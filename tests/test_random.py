"""Statistical validation of the branch-free samplers against scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from basicrta_tpu.ops import random as btr


def _draws(fn, key, shape):
    return np.asarray(fn(jax.random.key(key))).reshape(shape)


@pytest.mark.parametrize("n,p", [(5, 0.3), (40, 0.02), (100, 0.5),
                                 (1000, 0.013), (5000, 0.4), (200000, 0.25),
                                 (446605, 0.8), (17, 0.97)])
@pytest.mark.slow
def test_binomial_moments(n, p):
    size = 40000
    m = _draws(lambda k: btr.binomial(
        k, jnp.full((size,), float(n)), jnp.full((size,), p)), n, (size,))
    mean, var = n * p, n * p * (1 - p)
    assert m.mean() == pytest.approx(mean, abs=5 * np.sqrt(var / size))
    assert m.var() == pytest.approx(var, rel=0.1)
    assert m.min() >= 0 and m.max() <= n
    assert np.allclose(m, np.round(m))  # integer-valued


@pytest.mark.parametrize("n,p", [(8, 0.35), (30, 0.1), (60, 0.5)])
@pytest.mark.slow
def test_binomial_exact_pmf(n, p):
    """Chi-square goodness of fit against the exact Binomial PMF (covers the
    inversion path end to end)."""
    size = 60000
    m = _draws(lambda k: btr.binomial(
        k, jnp.full((size,), float(n)), jnp.full((size,), p)), 7, (size,))
    counts = np.bincount(m.astype(int), minlength=n + 1)
    pmf = stats.binom.pmf(np.arange(n + 1), n, p)
    keep = pmf * size > 5
    chi2 = np.sum((counts[keep] - size * pmf[keep]) ** 2 / (size * pmf[keep]))
    # generous threshold: dof ~ keep.sum(); p-value ~ 1e-4 cutoff
    assert chi2 < stats.chi2.ppf(0.9999, keep.sum() - 1)


def test_binomial_btrs_pmf():
    """Chi-square GOF on the BTRS path (n*p > 10)."""
    n, p, size = 300, 0.2, 60000
    m = _draws(lambda k: btr.binomial(
        k, jnp.full((size,), float(n)), jnp.full((size,), p)), 3, (size,))
    counts = np.bincount(m.astype(int), minlength=n + 1)
    pmf = stats.binom.pmf(np.arange(n + 1), n, p)
    keep = pmf * size > 5
    chi2 = np.sum((counts[keep] - size * pmf[keep]) ** 2 / (size * pmf[keep]))
    assert chi2 < stats.chi2.ppf(0.9999, keep.sum() - 1)


@pytest.mark.slow
def test_binomial_edges():
    k = jax.random.key(0)
    n = jnp.array([0.0, 10.0, 10.0, 7.0])
    p = jnp.array([0.5, 0.0, 1.0, 0.5])
    m = np.asarray(btr.binomial(k, n, p))
    assert m[0] == 0 and m[1] == 0 and m[2] == 10
    assert 0 <= m[3] <= 7


@pytest.mark.parametrize("a", [0.5, 1.0, 2.5, 40.0, 5000.0])
def test_gamma_ks(a):
    size = 40000
    g = _draws(lambda k: btr.gamma(k, jnp.full((size,), a)), int(a * 10),
               (size,))
    assert np.all(g > 0)
    ks = stats.kstest(g, "gamma", args=(a,))
    assert ks.pvalue > 1e-4, f"KS p={ks.pvalue} for a={a}"


def test_gamma_tiny_shape_moments():
    """a = 1/15 (the Dirichlet prior) underflows f32 for a visible fraction
    of draws; the distribution is validated on moments, which the tiny-clamp
    does not perturb."""
    a, size = 1.0 / 15.0, 60000
    g = _draws(lambda k: btr.gamma(k, jnp.full((size,), a)), 2, (size,))
    assert np.all(g > 0)
    assert g.mean() == pytest.approx(a, abs=5 * np.sqrt(a / size))
    assert g.var() == pytest.approx(a, rel=0.15)


def test_dirichlet_moments():
    alpha = np.array([1 / 15] * 15, dtype=np.float32) + np.arange(15,
                                                                  dtype=np.float32)
    size = 20000
    d = np.asarray(btr.dirichlet(jax.random.key(0),
                                 jnp.tile(jnp.asarray(alpha), (size, 1))))
    assert np.allclose(d.sum(axis=1), 1.0, atol=1e-5)
    a0 = alpha.sum()
    mean = alpha / a0
    var = alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1))
    assert np.allclose(d.mean(axis=0), mean, atol=5 * np.sqrt(var / size))


def test_multinomial_exact_totals():
    key = jax.random.key(0)
    n = jnp.array([0.0, 7.0, 446605.0])
    probs = jnp.tile(jnp.asarray(np.random.default_rng(0).dirichlet(
        np.ones(15)).astype(np.float32)), (3, 1))
    m = np.asarray(btr.multinomial(key, n, probs))
    assert np.allclose(m.sum(axis=1), np.asarray(n))
    assert np.all(m >= 0)


def test_multinomial_mean_cov():
    size, n = 30000, 50
    p = np.array([0.5, 0.3, 0.15, 0.05], dtype=np.float32)
    m = np.asarray(btr.multinomial(
        jax.random.key(1), jnp.full((size,), float(n)),
        jnp.tile(jnp.asarray(p), (size, 1))))
    assert np.allclose(m.mean(axis=0), n * p,
                       atol=5 * np.sqrt(n * p * (1 - p) / size))
    # off-diagonal covariance: cov(m_i, m_j) = -n p_i p_j
    c = np.cov(m.T)
    assert c[0, 1] == pytest.approx(-n * p[0] * p[1], rel=0.15)
