"""The fused segment kernel (sampler/pallas_sweep.py) in the Pallas
interpreter, its wrapper's shapes and padding, the engine selection, and
one compiled run on the card (``gpu`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import discretize_times, simulate_hyperexp
from basicrta_tpu.sampler.batch import (bucket_residues, resolve_engine,
                                        run_batch)
from basicrta_tpu.sampler.kernels import (MixtureState, compute_tiers,
                                          dedup_times, init_mixture_params)
from basicrta_tpu.sampler.pallas_sweep import chunk_tiers, segment_pallas


def _lanes(rng, sizes, dt=0.1):
    """(values, counts, tiers) of lanes sorted by multiplicity, padded to
    the longest lane with count-0 columns."""
    data = [dedup_times(discretize_times(simulate_hyperexp(
        n, [0.8, 0.2], [2.0, 0.1], rng), dt)) for n in sizes]
    V = max(len(v) for v, _ in data)
    values = np.ones((len(sizes), V))
    counts = np.zeros((len(sizes), V))
    for i, (v, c) in enumerate(data):
        values[i, :len(v)], counts[i, :len(c)] = v, c
    order, tiers = compute_tiers(counts)
    return (np.take_along_axis(values, order, -1),
            np.take_along_axis(counts, order, -1), tiers)


def _state(B, K):
    st = init_mixture_params(K)
    return MixtureState(jnp.tile(st.weights, (B, 1)),
                        jnp.tile(st.rates, (B, 1)))


def _run(values, counts, tiers, cfg, nb, seed=3, offset=0, lane_offset=0,
         state=None):
    B = values.shape[0]
    state = _state(B, cfg.ncomp) if state is None else state
    st, W, R = segment_pallas(
        jnp.int32(seed), jnp.int32(offset), state,
        jnp.asarray(values, jnp.float32), jnp.asarray(counts, jnp.float32),
        cfg, nb, tiers, interpret=True, lane_offset=jnp.int32(lane_offset))
    return (np.asarray(st.weights), np.asarray(st.rates), np.asarray(W),
            np.asarray(R))


def test_chunk_tiers():
    assert chunk_tiers((0, 0), 4) == (0, 0)           # all singleton
    assert chunk_tiers((1, 130), 4) == (1, 2)
    assert chunk_tiers((128, 128), 4) == (1, 1)
    assert chunk_tiers((513, 600), 4) == (4, 4)       # clamped to n_chunks
    assert chunk_tiers((3, 0), 2) == (1, 1)            # small >= head
    assert chunk_tiers((70, 200), 4, chunk=64) == (2, 4)


@pytest.mark.parametrize("sizes", [(400,), (900, 300), (3000, 60, 1500)])
def test_non_pow2_width_shapes(sizes):
    """Any V (padded inside the wrapper to whole chunks) gives the
    (B, n_blocks, K) thinned outputs of batch._segment, normalized."""
    values, counts, tiers = _lanes(np.random.default_rng(len(sizes)),
                                   sizes)
    assert values.shape[1] & (values.shape[1] - 1)    # not a power of 2
    cfg = GibbsConfig(ncomp=4, niter=60, g=10)
    w, r, W, R = _run(values, counts, tiers, cfg, 6)
    B = len(sizes)
    assert W.shape == R.shape == (B, 6, 4)
    assert w.shape == r.shape == (B, 4)
    assert np.all(np.isfinite(W)) and np.all(R > 0)
    assert np.allclose(W.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(W[:, -1], w)


def test_padding_columns_are_inert(rng):
    """Explicit count-0 padding columns change nothing: draws are keyed by
    column index and zero-count columns draw zero."""
    values, counts, tiers = _lanes(rng, (1200,))
    V = values.shape[1]
    pad = 128 * (-(-V // 128)) - V
    assert pad > 0
    vp = np.pad(values, ((0, 0), (0, pad)), constant_values=1.0)
    cp = np.pad(counts, ((0, 0), (0, pad)))
    cfg = GibbsConfig(ncomp=3, niter=40, g=10)
    a = _run(values, counts, tiers, cfg, 4)
    b = _run(vp, cp, tiers, cfg, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_k15_padded_component_masked(rng):
    """K = 15 runs as 16 state rows with one masked component, which must
    never leak into the outputs."""
    values, counts, tiers = _lanes(rng, (2000,))
    cfg = GibbsConfig(ncomp=15, niter=30, g=10)
    w, r, W, R = _run(values, counts, tiers, cfg, 3)
    assert W.shape == (1, 3, 15) and w.shape == (1, 15)
    assert np.allclose(W.sum(-1), 1.0, atol=1e-5)
    assert np.all(np.isfinite(R)) and np.all(R > 0)


def test_resume_bit_exact_any_segmentation(rng, tmp_path):
    """Sweeps are seeded by their absolute index, so segment sizes and a
    checkpointed resume reproduce the uninterrupted chain bit-exactly."""
    x = discretize_times(simulate_hyperexp(1500, [0.8, 0.2], [2.0, 0.1],
                                           rng), 0.1)
    batch = bucket_residues({"A1": x, "B2": x[:400]}, floor=256)[0]
    cfg = GibbsConfig(ncomp=4, niter=120, g=10, seed=4)
    kw = dict(engine="pallas", interpret=True)
    full = run_batch(batch, cfg, segment_blocks=12, **kw)
    seg = run_batch(batch, cfg, segment_blocks=5, **kw)
    np.testing.assert_array_equal(seg.mcweights, full.mcweights)

    class Stop(Exception):
        pass

    def bomb(seg_idx, state, _):
        if seg_idx == 2:
            raise Stop

    ckpt = str(tmp_path / "ck.npz")
    with pytest.raises(Stop):
        run_batch(batch, cfg, segment_blocks=3, checkpoint_path=ckpt,
                  checkpoint_cb=bomb, **kw)
    resumed = run_batch(batch, cfg, segment_blocks=3, checkpoint_path=ckpt,
                        **kw)
    np.testing.assert_array_equal(resumed.mcweights, full.mcweights)
    np.testing.assert_array_equal(resumed.mcrates, full.mcrates)


def test_lane_streams_keyed_by_global_index(rng):
    """A lane's stream depends on its global index (lane_offset + program
    id), not on which other lanes share the call — the property that
    makes lane-sharded runs equal unsharded ones."""
    values, counts, tiers = _lanes(rng, (800, 500))
    cfg = GibbsConfig(ncomp=3, niter=30, g=10)
    both = _run(values, counts, tiers, cfg, 3)
    second = _run(values[1:], counts[1:], tiers, cfg, 3, lane_offset=1)
    np.testing.assert_array_equal(both[2][1:], second[2])
    first = _run(values[:1], counts[:1], tiers, cfg, 3)
    np.testing.assert_array_equal(both[2][:1], first[2])
    assert not np.array_equal(both[2][0], both[2][1])


@pytest.mark.slow
def test_kernel_matches_xla_engine_in_law(rng):
    """The kernel and batch._segment sample the same posterior."""
    import chip_smoke
    x = discretize_times(simulate_hyperexp(
        15000, [0.8, 0.17, 0.03], [3.0, 0.25, 0.02], rng), 0.1)
    batch = bucket_residues({"R0#0": x, "R0#1": x})[0]
    cfg = GibbsConfig(ncomp=5, niter=3000, g=10, burnin=600, seed=3)
    rk = run_batch(batch, cfg, engine="pallas", interpret=True)
    rx = run_batch(batch, cfg, engine="xla")
    assert chip_smoke.law_check("kernel", rk.mcweights, rk.mcrates,
                                rx.mcweights, rx.mcrates, x,
                                cfg.burnin_samples)


def test_engine_selection_off_gpu():
    """Off the GPU, 'auto' is the XLA engine and the compiled kernel is an
    error unless the interpreter is asked for explicitly."""
    assert jax.devices()[0].platform == "cpu"
    assert resolve_engine("auto") == "xla"
    assert resolve_engine("xla") == "xla"
    assert resolve_engine("pallas", interpret=True) == "pallas"
    with pytest.raises(ValueError, match="NVIDIA GPU"):
        resolve_engine("pallas")
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("mosaic")


def test_run_batch_rejects_kernel_off_gpu(rng):
    x = discretize_times(simulate_hyperexp(300, [0.8, 0.2], [2.0, 0.1],
                                           rng), 0.1)
    batch = bucket_residues({"A": x})[0]
    cfg = GibbsConfig(ncomp=3, niter=20, g=10)
    with pytest.raises(ValueError, match="interpret=True"):
        run_batch(batch, cfg, engine="pallas")


@pytest.mark.gpu
def test_compiled_kernel_on_card(gpu, rng):
    """The kernel compiled for the card at a production width (V = 1024,
    K = 15): normalized finite samples, and the posterior of the XLA
    engine on the same card."""
    import chip_smoke
    x = discretize_times(simulate_hyperexp(
        200000, [0.87, 0.09, 0.03, 0.009, 0.001],
        [4.7, 1.3, 0.33, 0.06, 0.009], rng), 0.1)
    batch = bucket_residues({"R0#0": x, "R0#1": x})[0]
    cfg = GibbsConfig(ncomp=15, niter=5000, g=100, burnin=1000)
    rk = run_batch(batch, cfg, engine="pallas")
    rx = run_batch(batch, cfg, engine="xla")
    assert np.allclose(rk.mcweights.sum(-1), 1.0, atol=1e-4)
    assert chip_smoke.law_check("kernel", rk.mcweights, rk.mcrates,
                                rx.mcweights, rx.mcrates, x,
                                cfg.burnin_samples)
