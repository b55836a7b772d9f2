#!/usr/bin/env python
"""Goodness-of-fit battery for the fused kernel's in-kernel samplers.

The segment kernel (sampler/pallas_sweep.py) draws every random number
from its counter-hash uniforms (`_Rng`) and turns them into binomials
(`_binom_full`: inversion and BTRS branches) and gammas (`_gamma_mt`)
inside the kernel. This script compiles small Pallas kernels that emit
RAW draws from exactly those samplers and runs a scipy GOF battery on
them. On a GPU the kernels are compiled as the segment kernel is; with
``--interpret`` they run in the Pallas interpreter on any backend.

Usage:  python scripts/device_prng.py [--interpret]
"""

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as pltriton  # noqa: E402
from scipy import stats  # noqa: E402

from basicrta_tpu.sampler.pallas_sweep import (_Rng, _binom_full,  # noqa
                                               _gamma_mt)

_BLOCK = 1024        # draws per program
_PROGRAMS = 256      # programs per call -> 262,144 draws


def _call(kernel_body, seed, interpret):
    def kernel(seed_ref, out_ref):
        pid = pl.program_id(0)
        rng = _Rng(seed_ref[0], pid)
        elem = (pid * _BLOCK + jax.lax.broadcasted_iota(
            jnp.int32, (_BLOCK,), 0)).astype(jnp.uint32)
        out_ref[...] = kernel_body(rng, elem)

    return pl.pallas_call(
        kernel, grid=(_PROGRAMS,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,))],
        out_specs=pl.BlockSpec((_BLOCK,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((_PROGRAMS * _BLOCK,), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
    )(jnp.atleast_1d(jnp.int32(seed)))


@functools.partial(jax.jit, static_argnames=("interpret",))
def draw_uniform(seed, interpret=False):
    return _call(lambda rng, elem: rng.uniform(elem), seed, interpret)


@functools.partial(jax.jit, static_argnames=("n", "p", "interpret"))
def draw_binom(seed, n, p, interpret=False):
    def body(rng, elem):
        return _binom_full(rng, elem, jnp.full((_BLOCK,), float(n)),
                           jnp.full((_BLOCK,), float(p)))
    return _call(body, seed, interpret)


@functools.partial(jax.jit, static_argnames=("a", "interpret"))
def draw_gamma(seed, a, interpret=False):
    return _call(lambda rng, elem: _gamma_mt(
        rng, elem, jnp.full((_BLOCK,), float(a))), seed, interpret)


def collect(fn, reps, **kw):
    return np.concatenate([np.asarray(fn(jnp.int32(97 + 31 * s), **kw))
                           for s in range(reps)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true",
                    help="run the sampler kernels in the Pallas "
                         "interpreter (any backend)")
    args = ap.parse_args()
    if not args.interpret and jax.devices()[0].platform != "gpu":
        sys.exit("no GPU: compiled sampler kernels need one "
                 "(use --interpret)")
    interpret = args.interpret
    print(f"device: {jax.devices()[0]}; interpret={interpret}")
    failures = []

    u = collect(draw_uniform, 4, interpret=interpret)
    ks = stats.kstest(u, "uniform")
    mean_z = (u.mean() - 0.5) / (np.sqrt(1 / 12) / np.sqrt(len(u)))
    r1 = np.corrcoef(u[:-1], u[1:])[0, 1]
    print(f"[uniform] n={len(u)} KS p={ks.pvalue:.3g} mean_z={mean_z:.2f} "
          f"lag1_corr={r1:.2e}")
    if ks.pvalue < 1e-3 or abs(mean_z) > 5 or abs(r1) > 5 / np.sqrt(len(u)):
        failures.append("uniform")

    # inversion (n*p <= 10), BTRS (n*p > 10, incl. large n where the
    # accept test's amplified logs matter) and the symmetry fold (p > 0.5)
    for n, p in [(16, 0.35), (100, 0.02), (50, 0.3), (5000, 0.47),
                 (40, 0.9)]:
        x = collect(draw_binom, 2, n=n, p=p, interpret=interpret)
        kmax = int(x.max())
        obs = np.bincount(x.astype(int), minlength=kmax + 1)
        exp = stats.binom.pmf(np.arange(kmax + 1), n, p) * len(x)
        keep = exp >= 5
        obs_p = np.concatenate([obs[keep], [obs[~keep].sum()]])
        exp_p = np.concatenate([exp[keep], [len(x) - exp[keep].sum()]])
        sel = exp_p > 0
        chi2 = ((obs_p[sel] - exp_p[sel]) ** 2 / exp_p[sel]).sum()
        pval = stats.chi2.sf(chi2, max(sel.sum() - 1, 1))
        mz = (x.mean() - n * p) / (np.sqrt(n * p * (1 - p))
                                   / np.sqrt(len(x)))
        print(f"[binom n={n} p={p}] n={len(x)} chi2 p={pval:.3g} "
              f"mean_z={mz:.2f}")
        if pval < 1e-4 or abs(mz) > 5:
            failures.append(f"binom({n},{p})")

    for a in [0.0667, 1.0, 3.7, 500.0]:   # 1/15 = the Dirichlet prior
        x = collect(draw_gamma, 2, a=a, interpret=interpret)
        mz = (x.mean() - a) / (np.sqrt(a) / np.sqrt(len(x)))
        if a < 1.0:
            # Gamma(a << 1) has real mass below f32's smallest normals;
            # those draws clamp to the kernel's 1e-30 floor by design, so
            # test the censored distribution above a floor instead
            t0 = 1e-25
            p_below = stats.gamma.cdf(t0, a)
            ks = stats.kstest(
                x[x > t0], lambda v: ((stats.gamma.cdf(v, a) - p_below)
                                      / (1.0 - p_below)))
        else:
            ks = stats.kstest(x, "gamma", args=(a,))
        print(f"[gamma a={a}] n={len(x)} KS p={ks.pvalue:.3g} "
              f"mean_z={mz:.2f}")
        if ks.pvalue < 1e-3 or abs(mz) > 5:
            failures.append(f"gamma({a})")

    if failures:
        print(f"FAILED: {failures}")
        sys.exit(1)
    print("in-kernel sampler GOF battery: ALL PASS")


if __name__ == "__main__":
    main()
