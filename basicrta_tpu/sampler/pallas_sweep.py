"""Fused Gibbs-segment kernel for NVIDIA GPUs (Pallas, Triton route).

:func:`segment_pallas` advances every lane of a bucket by ``n_blocks * g``
collapsed Gibbs sweeps in ONE ``pallas_call``. The XLA engine
(``batch._segment``) runs each sweep as a nest of loops — the sweep scan,
the K-1 stage conditional-binomial scan per tier and the rejection rounds
inside the binomial and gamma samplers — and XLA:GPU issues every loop
iteration as its own kernel launches. Here the whole nest is one program
per lane:

- a ``fori_loop`` over sweeps, with the (w, r) chain state carried in
  registers and a thinned snapshot stored every g sweeps;
- inside each sweep, loops over value chunks of 128 columns. Within a
  chunk the K-stage chain accumulates the sufficient statistics
  (N_k, T_k) into state-sized vectors, so the chunk width, not V, bounds
  the registers a program needs;
- the chunk loops follow the multiplicity tiers of the sorted value axis:
  chunks holding counts > SMALL_NMAX draw with inversion + BTRS, chunks
  with counts <= SMALL_NMAX with a complete fixed-depth inversion, and
  chunks of counts in {0, 1} with one inverse-CDF categorical;
- the Dirichlet/Gamma conjugate update runs in the same program on the
  state vector, K padded to a power of two with masked components.

Every random number comes from the stateless counter hash
:func:`_hash_bits` of (seed, lane, call site, loop counter, column index).
Sweeps are seeded by their absolute index, so a run resumes bit-exactly at
any segmentation, and the kernel draws the same stream on the GPU as in
interpret mode on the CPU. Every sum is an f32 reduction (no ``pl.dot``,
which would run in TF32).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.precise import stirling_tail as _stirling_tail
from basicrta_tpu.sampler.kernels import MixtureState, SMALL_NMAX

_CHUNK = 128         # value columns per chunk (power of two)
_NUM_WARPS = 4       # one column per thread at the default chunk
_INV_FULL = 32       # head-tier inversion depth: covers n*p <= 10 beyond
                     # +6.9 sigma (all-steps-miss < 1e-11 per draw)
_INV_SMALL = SMALL_NMAX + 1
_BTRS_ROUNDS = 12    # failure < (0.21)^12 ~ 7e-9 -> mode fallback
_MT_ROUNDS = 8       # failure < (0.05)^8 ~ 4e-11 -> mode fallback
_TINY = 1e-30


def _bits_to_uniform(bits):
    """uint32 bits -> U[2^-25, 1) on the 24-bit mantissa grid."""
    u = ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
         * (1.0 / 16777216.0))
    return jnp.maximum(u, 1.0 / 33554432.0)


def _murmur_fmix(h):
    """murmur3 finalizer (avalanche mix) on uint32."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash_bits(seed, lane, site, t, elem):
    """Stateless counter-based random bits: hash of (seed, lane, static
    call-site tag, loop counter, element index ``elem`` (uint32 array))."""
    h = (jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
         ^ jnp.asarray(lane).astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    h = _murmur_fmix(h ^ (jnp.uint32(site) * jnp.uint32(0xC2B2AE35)
                          + jnp.asarray(t).astype(jnp.uint32)))
    return _murmur_fmix(h ^ _murmur_fmix(elem))


class _Rng:
    """Uniform source of one (sweep seed, lane): every call site draws
    from its own tag, so the stream of a site does not depend on how many
    draws other sites made."""

    def __init__(self, seed, lane):
        self.seed = seed
        self.lane = lane
        self.site = 0  # static call-site counter

    def uniform(self, elem, t=0):
        self.site += 1
        return _bits_to_uniform(
            _hash_bits(self.seed, self.lane, self.site, t, elem))


def _binom_inversion(u, n, p, depth: int):
    """CDF-inversion binomial walking ``depth`` PMF terms, complete for
    counts < depth (exact when n < depth)."""
    q = jnp.maximum(1.0 - p, _TINY)
    ratio = p / q
    # log1p: 1 - p rounds away the small p that n * log(q) amplifies
    pmf0 = jnp.exp(n * jnp.log1p(-jnp.minimum(p, 1.0 - 1e-7)))

    def step(t, carry):
        cdf, pmf, m = carry
        tf = t.astype(jnp.float32)
        m = m + jnp.where(u > cdf, 1.0, 0.0)
        pmf = jnp.where(n - tf > 0, pmf * ratio * (n - tf) / (tf + 1.0),
                        0.0)
        return cdf + pmf, pmf, m

    _, _, m = jax.lax.fori_loop(0, depth, step,
                                (pmf0, pmf0, jnp.zeros_like(u)))
    return jnp.where(p >= 1.0, n, jnp.minimum(m, n))


def _btrs_setup(n, p):
    """Per-element constants of Hormann's BTRS for n*p >= 10, p <= 0.5,
    with the BTRD form of the accept test (Hormann 1993)."""
    q = 1.0 - p
    spq = jnp.sqrt(n * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    c = n * p + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    r = jnp.maximum(p / q, _TINY)
    m = jnp.floor((n + 1.0) * p)
    nm = n - m + 1.0
    hb = ((m + 0.5) * jnp.log(jnp.maximum((m + 1.0) / (r * nm), _TINY))
          + _stirling_tail(m) + _stirling_tail(n - m))
    return a, b, c, vr, alpha, r, m, nm, hb


def _btrs_round(u, v, n, consts):
    """One BTRS proposal from uniforms (u, v): returns (k, accepted).

    The accept test is the BTRD regrouping ``hb + (n+1) log(nm/nk) +
    (k+0.5) log(nk r / (k+1)) - t(k) - t(n-k)`` of the lgamma form — the
    same quantity, but both logs take near-unity ratios, so the
    n-amplified terms carry small absolute error. Out-of-range k makes
    the ratios garbage (finite); the in-range gate discards them."""
    a, b, c, vr, alpha, r, _, nm, hb = consts
    u = u - 0.5
    us = 0.5 - jnp.abs(u)
    k = jnp.floor((2.0 * a / us + b) * u + c)
    in_range = (k >= 0) & (k <= n)
    fast = (us >= 0.07) & (v <= vr)
    vv = jnp.log(jnp.maximum(v * alpha / (a / (us * us) + b), _TINY))
    nk = n - k + 1.0
    slow = vv <= (hb + (n + 1.0) * jnp.log(jnp.maximum(nm / nk, _TINY))
                  + (k + 0.5) * jnp.log(jnp.maximum(nk * r / (k + 1.0),
                                                    _TINY))
                  - _stirling_tail(k) - _stirling_tail(n - k))
    return k, in_range & (fast | slow)


def _binom_btrs(rng, elem, n, p, skip, stage=0):
    """BTRS accept-first rounds until every element not ``skip``-ped has
    accepted (at most _BTRS_ROUNDS; the mode is the fallback). ``stage``
    keys the rounds' counters, so each chain stage draws its own
    stream."""
    consts = _btrs_setup(n, p)

    def cond(carry):
        t, _, done = carry
        return (t < _BTRS_ROUNDS) & (jnp.min(done) < 0.5)

    def body(carry):
        t, k_acc, done = carry
        ctr = stage * 16 + t
        k, ok = _btrs_round(rng.uniform(elem, ctr), rng.uniform(elem, ctr),
                            n, consts)
        upd = (1.0 - done) * jnp.where(ok, 1.0, 0.0)
        k_acc = k_acc * (1.0 - upd) + k * upd
        return t + 1, k_acc, jnp.maximum(done, upd)

    done0 = jnp.where(skip, 1.0, 0.0)
    _, k_acc, _ = jax.lax.while_loop(cond, body,
                                     (jnp.int32(0), consts[6], done0))
    return k_acc


def _binom_full(rng, elem, n, p, stage=0):
    """General exact binomial: symmetry fold, then inversion for
    n*p <= 10 and BTRS above."""
    p = jnp.clip(p, 0.0, 1.0)
    flip = p > 0.5
    p_eff = jnp.where(flip, 1.0 - p, p)
    small = n * p_eff <= 10.0
    m_inv = _binom_inversion(rng.uniform(elem, stage), n,
                             jnp.where(small, p_eff, 0.0), _INV_FULL)
    m_btrs = _binom_btrs(rng, elem, jnp.where(small, 100.0, n),
                         jnp.where(small, 0.3, p_eff), small, stage)
    m = jnp.where(small, m_inv, m_btrs)
    m = jnp.where(flip, n - m, m)
    m = jnp.where((p <= 0.0) | (n <= 0.0), 0.0, m)
    m = jnp.where(p >= 1.0, n, m)
    return jnp.clip(m, 0.0, jnp.maximum(n, 0.0))


def _normal_icdf(p):
    """Acklam's rational approximation of the standard normal inverse CDF
    (branch-free three-region select; |rel err| < 1.2e-9)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    cc = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
    dd = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
    plow = 0.02425
    p = jnp.clip(p, 1.0 / 33554432.0, 1.0 - 1.0 / 33554432.0)

    def tail(q):   # q = min(p, 1-p), evaluates the lower-tail branch
        s = jnp.sqrt(-2.0 * jnp.log(q))
        num = ((((cc[0] * s + cc[1]) * s + cc[2]) * s + cc[3]) * s
               + cc[4]) * s + cc[5]
        den = (((dd[0] * s + dd[1]) * s + dd[2]) * s + dd[3]) * s + 1.0
        return num / den

    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    central = num * q / den
    return jnp.where(p < plow, tail(p),
                     jnp.where(p > 1.0 - plow, -tail(1.0 - p), central))


def _gamma_mt(rng, elem, a):
    """Gamma(a, 1) by Marsaglia-Tsang squeeze rejection, rounds until all
    elements accept (at most _MT_ROUNDS; the mode v=1 is the fallback);
    shapes a < 1 boosted through Gamma(a+1) * U^(1/a)."""
    boost = a < 1.0
    d = jnp.where(boost, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    def cond(carry):
        t, _, done = carry
        return (t < _MT_ROUNDS) & (jnp.min(done) < 0.5)

    def body(carry):
        t, v_acc, done = carry
        x = _normal_icdf(rng.uniform(elem, t))
        u = rng.uniform(elem, t)
        v = (1.0 + c * x) ** 3
        ok = (v > 0.0) & (jnp.log(u) < 0.5 * x * x + d - d * v
                          + d * jnp.log(jnp.maximum(v, _TINY)))
        upd = (1.0 - done) * jnp.where(ok, 1.0, 0.0)
        v_acc = v_acc * (1.0 - upd) + v * upd
        return t + 1, v_acc, jnp.maximum(done, upd)

    _, v_acc, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.ones_like(a), jnp.zeros_like(a)))
    sample = d * v_acc
    boosted = sample * jnp.exp(jnp.log(rng.uniform(elem))
                               / jnp.maximum(a, _TINY))
    return jnp.maximum(jnp.where(boost, boosted, sample), _TINY)


def chunk_tiers(tiers: Tuple[int, int], n_chunks: int,
                chunk: int = _CHUNK) -> Tuple[int, int]:
    """Column tiers (head_end, single_start) -> chunk tiers: chunks
    [0, head) run the general sampler, [head, small) the small-count
    inversion, [small, n_chunks) the singleton categorical. Rounding a
    boundary up is always safe: each sampler is exact on every smaller
    count."""
    up = lambda x: -(-x // chunk)  # noqa: E731
    head = min(up(tiers[0]), n_chunks)
    small = min(max(up(tiers[1]), head), n_chunks)
    return head, small


def _segment_kernel(K: int, Kp: int, chunk: int, tiers: Tuple[int, int],
                    n_chunks: int, g: int, n_blocks: int, alpha: float,
                    ga: float, gb: float,
                    seed_ref, w0_ref, r0_ref, v_ref, c_ref,
                    w_out_ref, r_out_ref, w_fin_ref, r_fin_ref):
    """Run ``n_blocks * g`` sweeps for ONE lane (grid: (B,)).

    Refs: seed (4,) = (base seed, absolute sweep offset, index of this
    grid's first lane in the whole batch, unused); w0/r0 (Kp,);
    v/c (n_chunks * chunk,); thinned outputs (n_blocks, Kp); final state
    (Kp,). State vectors hold the components in REVERSED order — row
    j = Kp-1-k is component k and rows j < Kp-K are masked padding — so
    the suffix sums S_k = sum_{k' >= k} z_k' the chain needs are one
    forward cumulative sum over rows."""
    base_seed = seed_ref[0]
    offset = seed_ref[1]
    lane = pl.program_id(0) + seed_ref[2]
    head_chunks, small_chunks = tiers
    kio = jax.lax.broadcasted_iota(jnp.int32, (Kp,), 0)
    kio2 = jax.lax.broadcasted_iota(jnp.int32, (Kp, chunk), 0)
    live = kio >= Kp - K
    col = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)

    def load_chunk(ci, w, r):
        off = ci * chunk
        v = v_ref[pl.ds(off, chunk)]
        c = c_ref[pl.ds(off, chunk)]
        # z_k = w_k r_k exp(-r_k v) and its suffix sums (the softmax
        # normalization cancels in every conditional of the chain)
        z = (w * r)[:, None] * jnp.exp(-r[:, None] * v[None, :])
        return v, c, (off + col).astype(jnp.uint32), z, jnp.cumsum(z, 0)

    def row(x, j):
        return jnp.sum(jnp.where(kio2 == j, x, 0.0), axis=0)

    def chain_body(rng, w, r, draw_fn):
        # K-1 stage conditional-binomial chain over one chunk
        def body(ci, stats):
            v, c, elem, z, s = load_chunk(ci, w, r)

            def stage(kk, carry):
                rem, ns, ts = carry
                j = Kp - 1 - kk
                pcond = jnp.clip(row(z, j) / jnp.maximum(row(s, j), _TINY),
                                 0.0, 1.0)
                draw = draw_fn(rng, elem, rem, pcond, kk)
                ns = jnp.where(kio == j, ns + jnp.sum(draw), ns)
                ts = jnp.where(kio == j, ts + jnp.sum(v * draw), ts)
                return rem - draw, ns, ts

            rem, ns, ts = jax.lax.fori_loop(0, K - 1, stage, (c, *stats))
            j = Kp - K
            return (jnp.where(kio == j, ns + jnp.sum(rem), ns),
                    jnp.where(kio == j, ts + jnp.sum(v * rem), ts))
        return body

    def draw_small(rng, elem, n, p, kk):
        return _binom_inversion(rng.uniform(elem, kk), n, p, _INV_SMALL)

    def single_body(rng, w, r):
        # counts in {0, 1}: one uniform t per column; component k iff
        # S_k > t >= S_{k+1}, i.e. k = #{k' >= 1 : S_k' > t}
        def body(ci, stats):
            v, c, elem, _, s = load_chunk(ci, w, r)
            thresh = rng.uniform(elem) * row(s, Kp - 1)
            k = jnp.sum(jnp.where((kio2 < Kp - 1) & (s > thresh[None, :]),
                                  1, 0), axis=0)
            hit = kio2 == (Kp - 1 - k)[None, :]
            ns, ts = stats
            return (ns + jnp.sum(jnp.where(hit, c[None, :], 0.0), axis=1),
                    ts + jnp.sum(jnp.where(hit, (c * v)[None, :], 0.0),
                                 axis=1))
        return body

    def sweep(i, carry):
        w, r = carry
        # decorrelate sweeps by seed, not stream position: exact resume
        # at any block boundary
        seed_sweep = base_seed * jnp.int32(-1640531535) + offset + i
        rng = _Rng(seed_sweep, lane)
        stats = (jnp.zeros_like(w), jnp.zeros_like(w))
        if head_chunks > 0:
            stats = jax.lax.fori_loop(
                0, head_chunks, chain_body(rng, w, r, _binom_full), stats)
        if small_chunks > head_chunks:
            stats = jax.lax.fori_loop(head_chunks, small_chunks,
                                      chain_body(rng, w, r, draw_small),
                                      stats)
        if n_chunks > small_chunks:
            stats = jax.lax.fori_loop(small_chunks, n_chunks,
                                      single_body(rng, w, r), stats)
        ns, ts = stats
        # conjugate update (reference gibbs.py:210-211) on the padded
        # state vector; masked components keep weight 0 and rate 1
        kel = kio.astype(jnp.uint32)
        gw = _gamma_mt(rng, kel, jnp.where(live, alpha + ns, 1.0))
        gr = _gamma_mt(rng, kel, jnp.where(live, ga + ns, 1.0))
        gw = jnp.where(live, gw, 0.0)
        w_new = gw / jnp.sum(gw)
        r_new = jnp.where(live, gr / (gb + ts), 1.0)

        @pl.when(jax.lax.rem(i + 1, jnp.int32(g)) == 0)
        def _():
            blk = jax.lax.div(i + 1, jnp.int32(g)) - 1
            w_out_ref[blk, :] = w_new
            r_out_ref[blk, :] = r_new

        return w_new, r_new

    w_fin, r_fin = jax.lax.fori_loop(0, n_blocks * g, sweep,
                                     (w0_ref[...], r0_ref[...]))
    w_fin_ref[...] = w_fin
    r_fin_ref[...] = r_fin


@functools.partial(jax.jit, static_argnames=("cfg", "n_blocks", "tiers",
                                             "interpret"))
def segment_pallas(seed: jax.Array, sweep_offset: jax.Array,
                   state: MixtureState, values: jax.Array,
                   counts: jax.Array, cfg: GibbsConfig, n_blocks: int,
                   tiers: Tuple[int, int], interpret: bool = False,
                   lane_offset=0):
    """Advance all lanes by ``n_blocks`` thinning blocks in one fused
    kernel. Drop-in replacement for batch._segment (same thinned outputs,
    a different random stream).

    Args:
        seed: int32 scalar base seed.
        sweep_offset: int32 absolute sweep index of the segment start.
        state: (B, K) weights/rates.
        values/counts: (B, V), value columns sorted by multiplicity
            descending; any V (padded here to whole chunks).
        tiers: column tiers (head_end, single_start) from
            kernels.compute_tiers.
        interpret: run the kernel in the Pallas interpreter (tests on the
            CPU); compiled kernels need a GPU.
        lane_offset: int32 index of lane 0 in the whole batch. A lane's
            stream is keyed by its global index, so a lane-sharded run
            draws exactly the chains of the unsharded one.
    Returns:
        (state, W, R) with W/R (B, n_blocks, K) thinned samples.
    """
    from basicrta_tpu.sampler.batch import _next_pow2
    chunk = _CHUNK
    K = cfg.ncomp
    Kp = _next_pow2(K, floor=2)
    B, V = values.shape
    n_chunks = -(-V // chunk)
    pad_v = n_chunks * chunk - V
    values = jnp.pad(values.astype(jnp.float32), ((0, 0), (0, pad_v)),
                     constant_values=1.0)
    counts = jnp.pad(counts.astype(jnp.float32), ((0, 0), (0, pad_v)))
    # components reversed and padded at the front (see _segment_kernel)
    w0 = jnp.pad(state.weights.astype(jnp.float32)[:, ::-1],
                 ((0, 0), (Kp - K, 0)))
    r0 = jnp.pad(state.rates.astype(jnp.float32)[:, ::-1],
                 ((0, 0), (Kp - K, 0)), constant_values=1.0)
    seeds = jnp.stack([jnp.asarray(seed, jnp.int32),
                       jnp.asarray(sweep_offset, jnp.int32),
                       jnp.asarray(lane_offset, jnp.int32), jnp.int32(0)])
    kernel = functools.partial(
        _segment_kernel, K, Kp, chunk, chunk_tiers(tiers, n_chunks, chunk),
        n_chunks, cfg.g, n_blocks, cfg.alpha_eff, cfg.gamma_shape,
        cfg.gamma_rate)
    Vp = n_chunks * chunk
    lane_vec = lambda n: pl.BlockSpec((None, n), lambda b: (b, 0))  # noqa
    thinned = pl.BlockSpec((None, n_blocks, Kp), lambda b: (b, 0, 0))
    W, R, wf, rf = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[pl.BlockSpec((4,), lambda b: (0,)), lane_vec(Kp),
                  lane_vec(Kp), lane_vec(Vp), lane_vec(Vp)],
        out_specs=[thinned, thinned, lane_vec(Kp), lane_vec(Kp)],
        out_shape=[jax.ShapeDtypeStruct((B, n_blocks, Kp), jnp.float32),
                   jax.ShapeDtypeStruct((B, n_blocks, Kp), jnp.float32),
                   jax.ShapeDtypeStruct((B, Kp), jnp.float32),
                   jax.ShapeDtypeStruct((B, Kp), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="gibbs_segment",
    )(seeds, w0, r0, values, counts)
    unpad = lambda x: x[..., Kp - K:][..., ::-1]  # noqa: E731
    return MixtureState(unpad(wf), unpad(rf)), unpad(W), unpad(R)
