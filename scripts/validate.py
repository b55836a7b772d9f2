#!/usr/bin/env python
"""Statistical validation against the reference algorithm on real data.

Two checks (run from the repo root; pass the path to a residence-time .npy,
e.g. the reference package's bundled W313 dataset):

1. FULL RUN — the framework's default-configuration posterior
   (K=15, 110k sweeps, thinning 100, burn-in 10k) on the full dataset,
   with tau of the slowest process and its 95% CI.
2. CROSS-CHECK — on a random subsample (tractable for a per-event numpy
   sampler), the framework's posterior vs an independent numpy
   implementation of the reference's per-event sweep semantics: KS tests
   on the dominant-component weight/rate samples and slowest-process tau
   CI overlap.

Usage: python scripts/validate.py /path/to/times.npy [--subsample 40000]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from basicrta_tpu.jax_cache import enable_compilation_cache  # noqa: E402,E501

enable_compilation_cache()

from scipy import stats  # noqa: E402

from basicrta_tpu.config import GibbsConfig  # noqa: E402
from basicrta_tpu.sampler.batch import bucket_residues, run_batch  # noqa
from tests.test_equivalence import numpy_reference_sampler  # noqa: E402


def dominant(W, R, burn):
    Wp, Rp = W[burn:], R[burn:]
    k = Wp.mean(axis=0).argmax()
    return Wp[:, k], Rp[:, k]


def slow_taus(W, R, burn, wcut):
    Wp, Rp = W[burn:], R[burn:]
    live = Wp.mean(0) > wcut
    k = np.where(live)[0][Rp.mean(0)[live].argmin()]
    return 1.0 / Rp[:, k]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("times")
    ap.add_argument("--subsample", type=int, default=40_000)
    ap.add_argument("--sub-niter", type=int, default=10_000)
    ap.add_argument("--protein-residues", type=int, default=50,
                    help="residue count of the full-protein post-processing "
                         "throughput check (0 disables)")
    args = ap.parse_args()

    x = np.load(args.times)
    print(f"dataset: N={len(x)}, range [{x.min()}, {x.max()}] ns")

    # ---- 1. full default-config run through the product pipeline ------- #
    from basicrta_tpu.sampler.gibbs import Gibbs
    cfg = GibbsConfig()  # ncomp=15, niter=110000, g=100, burnin=10000
    g = Gibbs(x, residue="W313", cutoff=7.0, cfg=cfg)
    t0 = time.time()
    g.run(save=False)
    wall = time.time() - t0
    t0 = time.time()
    g.process_gibbs(save=False)
    lo, mode, hi = g.estimate_tau()
    t_post = time.time() - t0
    print(f"FULL RUN ({cfg.niter} sweeps, K={cfg.ncomp}): sampling "
          f"{wall:.1f}s ({cfg.niter / wall:,.0f} sweeps/s), "
          f"post-processing {t_post:.1f}s")
    print(f"  slowest-process tau = {mode:.1f} ns, 95% CI "
          f"[{lo:.1f}, {hi:.1f}]  (lmode={g.processed.lmode})")

    # ---- 2. subsample cross-check vs reference semantics --------------- #
    rng = np.random.default_rng(0)
    sub = rng.choice(x, size=min(args.subsample, len(x)), replace=False)
    cfg2 = GibbsConfig(ncomp=10, niter=args.sub_niter, g=10,
                       burnin=args.sub_niter // 5, seed=3)
    t0 = time.time()
    Wn, Rn = numpy_reference_sampler(sub, cfg2, seed=1)
    t_np = time.time() - t0
    t0 = time.time()
    batch2 = bucket_residues({"R": sub})[0]
    res2 = run_batch(batch2, cfg2, engine="auto")
    t_us = time.time() - t0
    b2 = cfg2.burnin_samples
    w_ref, r_ref = dominant(Wn, Rn, b2)
    w_our, r_our = dominant(res2.mcweights[0], res2.mcrates[0], b2)
    ks_w = stats.ks_2samp(w_ref, w_our)
    ks_r = stats.ks_2samp(r_ref, r_our)
    wcut2 = cfg2.wcutoff(len(sub))
    t_refs = slow_taus(Wn, Rn, b2, wcut2)
    t_ours = slow_taus(res2.mcweights[0], res2.mcrates[0], b2, wcut2)
    ci_ref = np.percentile(t_refs, [2.5, 97.5])
    ci_our = np.percentile(t_ours, [2.5, 97.5])
    print(f"CROSS-CHECK (N={len(sub)}, {cfg2.niter} sweeps): "
          f"numpy-reference {t_np:.0f}s vs framework {t_us:.1f}s "
          f"({t_np / max(t_us, 1e-9):,.0f}x)")
    print(f"  dominant weight: ref {w_ref.mean():.4f} vs ours "
          f"{w_our.mean():.4f} (KS p={ks_w.pvalue:.3f})")
    print(f"  dominant rate:   ref {r_ref.mean():.4f} vs ours "
          f"{r_our.mean():.4f} (KS p={ks_r.pvalue:.3f})")
    print(f"  slowest tau CI:  ref [{ci_ref[0]:.1f}, {ci_ref[1]:.1f}] vs "
          f"ours [{ci_our[0]:.1f}, {ci_our[1]:.1f}]")

    # ---- 3. full-protein post-processing throughput --------------------- #
    # batched (bucketed vmapped GMM + votes) post-processing must stay
    # within ~2x of sampling wall-clock (the per-residue loop cost
    # ~11 s x N residues)
    n_res = args.protein_residues
    if n_res:
        from basicrta_tpu.ops.surv import discretize_times, simulate_hyperexp
        from basicrta_tpu.protein.driver import finish_batch
        from basicrta_tpu.sampler.batch import run_residues
        rng = np.random.default_rng(1)
        sizes = (10 ** rng.uniform(2.0, 5.3, n_res)).astype(int)
        times = {f"X{i}": discretize_times(simulate_hyperexp(
            int(n), [0.87, 0.09, 0.03, 0.009, 0.001],
            np.array([4.7, 1.3, 0.33, 0.06, 0.009]) * rng.uniform(0.7, 1.5),
            rng), 0.1) for i, n in enumerate(sizes)}
        cfg3 = GibbsConfig()  # full default config
        t0 = time.time()
        samples = run_residues(times, cfg3, engine="auto")
        t_samp = time.time() - t0
        gibbs = {}
        for lab, (W, R) in samples.items():
            gg = Gibbs(times[lab], residue=lab, cutoff=7.0, cfg=cfg3)
            gg.mcweights, gg.mcrates = W, R
            gibbs[lab] = gg
        t0 = time.time()
        finish_batch(gibbs, save=False)
        t_fin = time.time() - t0
        # second pass over the same residues reuses every compiled bucket
        # program: the steady-state (per-protein) post-processing cost once
        # the persistent compilation cache is warm
        t0 = time.time()
        finish_batch(gibbs, save=False)
        t_fin2 = time.time() - t0
        n_ok = sum(1 for g_ in gibbs.values() if g_.tau is not None)
        print(f"FULL PROTEIN ({n_res} residues, {cfg3.niter} sweeps): "
              f"sampling {t_samp:.1f}s, post-processing {t_fin:.1f}s cold / "
              f"{t_fin2:.1f}s warm ({t_fin2 / t_samp:.2f}x sampling; "
              f"{n_ok}/{n_res} taus)")


if __name__ == "__main__":
    main()
