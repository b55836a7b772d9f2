"""Tests of the fused segment kernel's samplers and numerics (the kernel
itself runs in the Pallas interpreter on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import simulate_hyperexp, discretize_times
from basicrta_tpu.sampler.batch import bucket_residues, run_batch


def test_gammaln_lanczos():
    from scipy.special import gammaln as ref
    from basicrta_tpu.ops.precise import gammaln_f32
    x = jnp.asarray([0.5, 1.0, 2.0, 7.3, 40.0, 2000.0, 446606.0],
                    jnp.float32)
    ours = np.asarray(gammaln_f32(x))
    expect = ref(np.asarray(x, np.float64))
    assert np.allclose(ours, expect, rtol=2e-5, atol=1e-5)


def test_stirling_tail_matches_lgamma():
    from scipy.special import gammaln as ref
    from basicrta_tpu.ops.precise import stirling_tail
    x = np.asarray([0, 1, 2, 5, 9, 9.0, 10, 23, 400, 44660], np.float64)
    expect = ref(x + 1) - ((x + 0.5) * np.log(x + 1) - (x + 1)
                           + 0.5 * np.log(2 * np.pi))
    ours = np.asarray(stirling_tail(jnp.asarray(x, jnp.float32)))
    assert np.allclose(ours, expect, atol=2e-7)


@pytest.mark.slow
def test_binom_btrs_modes_gof():
    """Chi-square GOF of the kernel's BTRS binomial against the exact PMF,
    drawn with the kernel's counter-hash RNG outside a kernel (the same
    arithmetic the compiled and interpreted kernels run)."""
    from scipy import stats
    from basicrta_tpu.sampler.pallas_sweep import _Rng, _binom_btrs
    n, p, size = 300.0, 0.2, 50000
    draws = []
    for seed in range(5):
        rng = _Rng(jnp.int32(seed), jnp.int32(0))
        elem = jnp.arange(size // 5, dtype=jnp.uint32)
        m = _binom_btrs(rng, elem, jnp.full((size // 5,), n),
                        jnp.full((size // 5,), p),
                        jnp.zeros((size // 5,), bool))
        draws.append(np.asarray(m))
    m = np.concatenate(draws)
    counts = np.bincount(m.astype(int), minlength=int(n) + 1)
    pmf = stats.binom.pmf(np.arange(int(n) + 1), int(n), p)
    keep = pmf * size > 5
    chi2 = np.sum((counts[keep] - size * pmf[keep]) ** 2
                  / (size * pmf[keep]))
    assert chi2 < stats.chi2.ppf(0.9999, keep.sum() - 1)


def test_binom_btrd_agrees_with_lgamma_form():
    """BTRD is an algebraic regrouping of the lgamma accept test: for the
    same proposals, the kernel's f32 BTRD decision must match the lgamma
    form evaluated in f64, up to f32 boundary flips (marginal decisions,
    well below 0.3% of proposals)."""
    from scipy.special import gammaln
    from basicrta_tpu.sampler.pallas_sweep import _btrs_round, _btrs_setup
    rng = np.random.default_rng(5)
    size = 40000
    for n, p in [(120.0, 0.45), (5000.0, 0.47), (800.0, 0.05)]:
        u = rng.uniform(2 ** -25, 1, size).astype(np.float32)
        v = rng.uniform(2 ** -25, 1, size).astype(np.float32)
        nn = jnp.full((size,), n, jnp.float32)
        k, ok = _btrs_round(jnp.asarray(u), jnp.asarray(v), nn,
                            _btrs_setup(nn, jnp.full((size,), p,
                                                     jnp.float32)))
        k, ok = np.asarray(k, np.float64), np.asarray(ok)
        q = 1.0 - p
        spq = np.sqrt(n * p * q)
        b = 1.15 + 2.53 * spq
        a = -0.0873 + 0.0248 * b + 0.01 * p
        vr = 0.92 - 4.2 / b
        alpha = (2.83 + 5.1 / b) * spq
        m = np.floor((n + 1.0) * p)
        us = 0.5 - np.abs(u.astype(np.float64) - 0.5)
        v64 = v.astype(np.float64)
        inr = (k >= 0) & (k <= n)
        kk = np.clip(k, 0, n)
        vv = np.log(v64 * alpha / (a / (us * us) + b))
        slow = vv <= (gammaln(m + 1) + gammaln(n - m + 1) - gammaln(kk + 1)
                      - gammaln(n - kk + 1) + (kk - m) * np.log(p / q))
        ref = inr & (((us >= 0.07) & (v64 <= vr)) | slow)
        agree = np.mean(ok == ref)
        assert agree > 0.997, f"n={n} p={p}: agreement {agree}"


@pytest.mark.slow
def test_engine_agreement(rng):
    """Kernel (interpreted) and XLA engines sample statistically
    equivalent posteriors."""
    x = discretize_times(simulate_hyperexp(
        15000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02], rng), 0.1)
    batch = bucket_residues({"R0": x})[0]
    cfg = GibbsConfig(ncomp=5, niter=1500, g=10, burnin=500, seed=3)
    rx = run_batch(batch, cfg, engine="xla")
    rp = run_batch(batch, cfg, engine="pallas", interpret=True)
    b = cfg.burnin_samples
    for r in (rx, rp):
        assert np.all(np.isfinite(r.mcweights))
    wx, wp = rx.mcweights[0][b:], rp.mcweights[0][b:]
    ix, ip = wx.mean(0).argmax(), wp.mean(0).argmax()
    assert wx.mean(0)[ix] == pytest.approx(wp.mean(0)[ip], rel=0.05)
    assert (rx.mcrates[0][b:, ix].mean()
            == pytest.approx(rp.mcrates[0][b:, ip].mean(), rel=0.05))


class TestPreciseTranscendentals:
    """log_f32/exp_f32/pow_smallint (ops.precise): polynomial log/exp for
    the XLA engine's amplified sites, pmf0 = exp(n log q) above all.
    Target ~2 ulp."""

    def test_log_accuracy(self, rng):
        from basicrta_tpu.ops.precise import log_f32
        x = np.concatenate([
            rng.uniform(1e-30, 1e-6, 2000),
            rng.uniform(1e-6, 1.0, 20000),
            rng.uniform(1.0, 1e6, 20000),
            [1.0, 0.5, 2.0, 1.4142135, 0.65]]).astype(np.float32)
        got = np.asarray(log_f32(jnp.asarray(x)))
        ref = np.log(x.astype(np.float64))
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-10)
        assert rel.max() < 5e-7
        assert float(log_f32(jnp.float32(1.0))) == 0.0

    def test_exp_accuracy(self, rng):
        from basicrta_tpu.ops.precise import exp_f32
        x = np.concatenate([rng.uniform(-80, 80, 40000),
                            [0.0, 1.0, -1.0, 80.0, -80.0]]).astype(
            np.float32)
        got = np.asarray(exp_f32(jnp.asarray(x)))
        ref = np.exp(x.astype(np.float64))
        assert np.abs(got / ref - 1).max() < 5e-7
        assert float(exp_f32(jnp.float32(0.0))) == 1.0

    def test_pow_smallint_exact(self, rng):
        from basicrta_tpu.ops.precise import pow_smallint
        q = rng.uniform(0.01, 1.0, 200).astype(np.float32)
        for n in range(0, 32):
            got = np.asarray(pow_smallint(
                jnp.asarray(q), jnp.full(200, float(n), jnp.float32), 5))
            ref = q.astype(np.float64) ** n
            ok = ref > 1e-35       # f32-representable (no underflow)
            assert np.abs(got[ok] / ref[ok] - 1).max() < 3e-6

    def test_amplified_cdf_total(self):
        """The defect's reproduction: sum of binomial pmf via the
        recurrence must reach 1 to f32 accuracy for every (n, p) the
        inversion tiers see."""
        from basicrta_tpu.ops.precise import exp_f32, log_f32
        for n, p in [(16, 0.35), (100, 0.02), (500, 0.004), (31, 0.3)]:
            q = 1.0 - p
            pmf = float(np.asarray(exp_f32(jnp.float32(
                n) * log_f32(jnp.float32(q)))))
            total = pmf
            for t in range(min(n, 64)):
                pmf = pmf * (p / q) * (n - t) / (t + 1.0)
                total += pmf
            assert abs(total - 1.0) < 5e-5, (n, p, total)
