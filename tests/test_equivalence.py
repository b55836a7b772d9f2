"""Statistical equivalence vs the reference algorithm's semantics.

An independent numpy implementation of the reference's per-event sweep
(model semantics of reference gibbs.py:191-217: responsibilities ->
categorical indicators -> conjugate Dirichlet/Gamma draws, numpy PCG64 RNG)
provides ground truth; the framework's samplers must produce posteriors
that match it distributionally (the RNGs differ, so the comparison is
KS/CI-based, not bitwise — SURVEY.md section 7 'hard parts' (b)).
"""

import numpy as np
import pytest
from scipy import stats

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import simulate_hyperexp, discretize_times
from basicrta_tpu.sampler.batch import bucket_residues, run_batch

# statistical equivalence vs the independent numpy reference sampler (run with -m slow)
pytestmark = pytest.mark.slow


def numpy_reference_sampler(x, cfg: GibbsConfig, seed=0):
    """Per-event conjugate Gibbs sweeps with numpy's PCG64 — the reference
    model's semantics, written independently (same math, fresh code)."""
    rng = np.random.default_rng(seed)
    K = cfg.ncomp
    alpha = np.full(K, cfg.alpha_eff)
    a, b = cfg.gamma_shape, cfg.gamma_rate
    inrates = 0.5 * 10.0 ** np.arange(-K + 2, 2, dtype=float)
    tmpw = 9.0 * 10.0 ** (-np.arange(1, K + 1, dtype=float))
    w, r = tmpw / tmpw.sum(), inrates[::-1].copy()

    S = cfg.niter // cfg.g
    W = np.empty((S, K))
    R = np.empty((S, K))
    for j in range(1, cfg.niter + 1):
        z = w * r * np.exp(-np.outer(x, r))
        z /= z.sum(axis=1, keepdims=True)
        # categorical indicator per event via inverse CDF
        u = rng.random(len(x))
        s = (u[:, None] > np.cumsum(z, axis=1)).sum(axis=1)
        s = np.minimum(s, K - 1)
        Ns = np.bincount(s, minlength=K).astype(float)
        Ts = np.bincount(s, weights=x, minlength=K)
        w = rng.dirichlet(alpha + Ns)
        r = rng.gamma(a + Ns, 1.0 / (b + Ts))
        if j % cfg.g == 0:
            W[j // cfg.g - 1] = w
            R[j // cfg.g - 1] = r
    return W, R


@pytest.fixture(scope="module")
def equivalence_runs():
    rng = np.random.default_rng(99)
    x = discretize_times(simulate_hyperexp(
        12000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02], rng), 0.1)
    cfg = GibbsConfig(ncomp=5, niter=3000, g=10, burnin=1000, seed=11)
    Wn, Rn = numpy_reference_sampler(x, cfg, seed=1)
    batch = bucket_residues({"R": x})[0]
    ours = {eng: run_batch(batch, cfg, engine=eng,
                           interpret=eng == "pallas")
            for eng in ("xla", "pallas")}
    return x, cfg, (Wn, Rn), ours


def _dominant(W, R, burn):
    """Posterior samples (weights, rates) of the heaviest component."""
    Wp, Rp = W[burn:], R[burn:]
    k = Wp.mean(axis=0).argmax()
    return Wp[:, k], Rp[:, k]


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_posterior_matches_reference_semantics(equivalence_runs, engine):
    x, cfg, (Wn, Rn), ours = equivalence_runs
    burn = cfg.burnin_samples
    w_ref, r_ref = _dominant(Wn, Rn, burn)
    res = ours[engine]
    w_our, r_our = _dominant(res.mcweights[0], res.mcrates[0], burn)

    # posterior means agree within a few posterior standard errors
    for ref, our in [(w_ref, w_our), (r_ref, r_our)]:
        se = ref.std() * np.sqrt(2.0 / len(ref))
        # thinned samples autocorrelate; allow a generous factor
        assert abs(ref.mean() - our.mean()) < 8 * se + 1e-4, (
            f"{engine}: {ref.mean()} vs {our.mean()}")

    # full-distribution check: two-sample KS on the dominant rate
    ks = stats.ks_2samp(r_ref, r_our)
    assert ks.pvalue > 1e-4, f"{engine}: KS p={ks.pvalue}"


def _real_times():
    from basicrta_tpu.datafiles import real_times_path
    return real_times_path()


@pytest.mark.skipif(_real_times() is None,
                    reason="reference times.npy not available")
def test_real_data_posterior_equivalence():
    """Equivalence on (a subsample of) the reference's bundled 446,605-
    event W313 dataset: framework posterior vs the independent numpy
    reference-semantics sampler. Auto-skips when the dataset is absent."""
    x_full = np.load(_real_times())
    assert len(x_full) == 446_605          # the documented fixture
    rng = np.random.default_rng(4)
    x = np.sort(rng.choice(x_full, size=20_000, replace=False))
    cfg = GibbsConfig(ncomp=5, niter=1200, g=10, burnin=400, seed=21)
    Wn, Rn = numpy_reference_sampler(x, cfg, seed=2)
    batch = bucket_residues({"W313": x})[0]
    res = run_batch(batch, cfg, engine="pallas", interpret=True)

    burn = cfg.burnin_samples
    w_ref, r_ref = _dominant(Wn, Rn, burn)
    w_our, r_our = _dominant(res.mcweights[0], res.mcrates[0], burn)
    for ref, our in [(w_ref, w_our), (r_ref, r_our)]:
        se = ref.std() * np.sqrt(2.0 / len(ref))
        assert abs(ref.mean() - our.mean()) < 8 * se + 1e-4, (
            ref.mean(), our.mean())
    ks = stats.ks_2samp(r_ref, r_our)
    assert ks.pvalue > 1e-4, f"KS p={ks.pvalue}"


def test_tau_matches_reference_semantics(equivalence_runs):
    """Slowest-process tau from both sampler families covers the truth and
    each other's point estimate."""
    x, cfg, (Wn, Rn), ours = equivalence_runs
    burn = cfg.burnin_samples
    wcut = cfg.wcutoff(len(x))

    def slow_taus(W, R):
        Wp, Rp = W[burn:], R[burn:]
        live = Wp.mean(0) > wcut
        k = np.where(live)[0][Rp.mean(0)[live].argmin()]
        return 1.0 / Rp[:, k]

    t_ref = slow_taus(Wn, Rn)
    t_our = slow_taus(ours["pallas"].mcweights[0], ours["pallas"].mcrates[0])
    lo_r, hi_r = np.percentile(t_ref, [2.5, 97.5])
    lo_o, hi_o = np.percentile(t_our, [2.5, 97.5])
    # intervals overlap and both cover the true slowest tau (1/0.02 = 50,
    # shifted slightly by discretization)
    assert max(lo_r, lo_o) < min(hi_r, hi_o)
    assert lo_o < 55 and hi_o > 42
