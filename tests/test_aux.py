"""Tests for auxiliary subsystems: checkpoint/resume, failure detection,
homologue delta-tau, and convergence diagnostics."""

import os

import numpy as np
import pytest

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import simulate_hyperexp, discretize_times


class TestCheckpointResume:
    @pytest.mark.slow
    def test_resume_reproduces_uninterrupted(self, tmp_path, rng):
        from basicrta_tpu.sampler.batch import (bucket_residues, run_batch,
                                                load_checkpoint)
        x = discretize_times(simulate_hyperexp(
            3000, [0.8, 0.2], [2.0, 0.1], rng), 0.1)
        # explicit floor keeps both residues in ONE bucket (the default
        # ladder may class them by unique-count into separate buckets)
        batch = bucket_residues({"A1": x, "B2": x[:500]}, floor=1024)[0]
        cfg = GibbsConfig(ncomp=4, niter=600, g=10, seed=9)

        full = run_batch(batch, cfg, segment_blocks=20)

        # interrupted run: stop after 2 segments by raising from the cb
        ckpt = str(tmp_path / "ck.npz")

        class Stop(Exception):
            pass

        def bomb(seg_idx, state, _):
            if seg_idx == 2:
                raise Stop

        with pytest.raises(Stop):
            run_batch(batch, cfg, segment_blocks=20, checkpoint_path=ckpt,
                      checkpoint_cb=bomb)
        assert os.path.exists(ckpt)
        resumed_state = load_checkpoint(ckpt, batch, cfg)
        assert resumed_state is not None and resumed_state[0] == 40

        resumed = run_batch(batch, cfg, segment_blocks=20,
                            checkpoint_path=ckpt)
        assert np.allclose(resumed.mcweights, full.mcweights)
        assert np.allclose(resumed.mcrates, full.mcrates)
        assert not os.path.exists(ckpt)  # cleaned up on completion

    @pytest.mark.slow
    def test_pallas_resume_segmentation_independent(self, tmp_path, rng):
        """The fused engine re-seeds per (seed, absolute sweep index), so a
        resumed run — and even a differently-segmented run — reproduces the
        uninterrupted chain bit-exactly."""
        from basicrta_tpu.sampler.batch import bucket_residues, run_batch
        x = discretize_times(simulate_hyperexp(
            1500, [0.8, 0.2], [2.0, 0.1], rng), 0.1)
        batch = bucket_residues({"A1": x}, floor=256)[0]
        cfg = GibbsConfig(ncomp=4, niter=200, g=10, seed=4)

        kw = dict(engine="pallas", interpret=True)
        full = run_batch(batch, cfg, segment_blocks=20, **kw)
        # different segmentation, same chain
        seg = run_batch(batch, cfg, segment_blocks=7, **kw)
        assert np.allclose(seg.mcweights, full.mcweights, atol=1e-6)

        ckpt = str(tmp_path / "ckp.npz")

        class Stop(Exception):
            pass

        def bomb(seg_idx, state, _):
            if seg_idx == 2:
                raise Stop

        with pytest.raises(Stop):
            run_batch(batch, cfg, segment_blocks=5,
                      checkpoint_path=ckpt, checkpoint_cb=bomb, **kw)
        resumed = run_batch(batch, cfg, segment_blocks=5,
                            checkpoint_path=ckpt, **kw)
        assert np.allclose(resumed.mcweights, full.mcweights, atol=1e-6)
        assert np.allclose(resumed.mcrates, full.mcrates, atol=1e-6)

    def test_checkpoint_rejects_mismatched_workload(self, tmp_path, rng):
        from basicrta_tpu.sampler.batch import (bucket_residues,
                                                save_checkpoint,
                                                load_checkpoint)
        from basicrta_tpu.sampler.kernels import (MixtureState,
                                                  init_mixture_params)
        import jax.numpy as jnp
        x = discretize_times(simulate_hyperexp(
            500, [0.8, 0.2], [2.0, 0.1], rng), 0.1)
        batch = bucket_residues({"A1": x})[0]
        cfg = GibbsConfig(ncomp=4, niter=100, g=10)
        st = init_mixture_params(4)
        state = MixtureState(jnp.tile(st.weights, (1, 1)),
                             jnp.tile(st.rates, (1, 1)))
        p = save_checkpoint(str(tmp_path / "c.npz"), batch, cfg, 5, 1,
                            state, [], [])
        other_cfg = GibbsConfig(ncomp=4, niter=100, g=10, seed=77)
        assert load_checkpoint(p, batch, other_cfg) is None
        assert load_checkpoint(p, batch, cfg) is not None


class TestFailureDetection:
    def test_missing_and_skipped(self, tmp_path):
        from basicrta_tpu.protein.driver import ProcessProtein
        cfg = GibbsConfig(niter=100)
        base = tmp_path / "basicrta-7.0"
        (base / "W10").mkdir(parents=True)
        np.savez(base / "W10" / "gibbs_100.npz", x=1)  # done
        (base / "A11").mkdir()                          # missing
        (base / "G12").mkdir()                          # skipped
        (base / "G12" / ".dataset_too_small").touch()
        pp = ProcessProtein(cfg=cfg, cutoff=7.0, root=str(tmp_path))
        pp.collect_results()
        assert pp.missing_residues() == ["A11"]


class TestHomologues:
    ALN = """>protA/1-6
MKT-LV
>protB/1-5
MRTA-V
"""

    def test_matched_columns(self, tmp_path):
        from basicrta_tpu.protein.homologues import (parse_fasta_alignment,
                                                     matched_columns)
        p = tmp_path / "aln.fa"
        p.write_text(self.ALN)
        seqs = parse_fasta_alignment(str(p))
        assert list(seqs) == ["protA", "protB"]
        iA, iB = matched_columns(seqs["protA"], seqs["protB"])
        # columns 0,1,2,5 are non-gap in both
        assert np.array_equal(iA, [0, 1, 2, 4])
        assert np.array_equal(iB, [0, 1, 2, 4])
        iA2, iB2 = matched_columns(seqs["protA"], seqs["protB"],
                                   identical_only=True)
        assert np.array_equal(iA2, [0, 2, 4])  # M, T, V

    def test_kabsch_recovers_rotation(self, rng):
        from basicrta_tpu.protein.homologues import kabsch
        P = rng.normal(size=(30, 3))
        theta = 0.7
        R_true = np.array([[np.cos(theta), -np.sin(theta), 0],
                           [np.sin(theta), np.cos(theta), 0],
                           [0, 0, 1.0]])
        Q = P @ R_true.T + np.array([1.0, -2.0, 3.0])
        R, t, rmsd = kabsch(P, Q)
        assert rmsd < 1e-8
        assert np.allclose(R, R_true, atol=1e-8)

    def test_delta_tau(self, tmp_path):
        from basicrta_tpu.protein.homologues import delta_tau
        p = tmp_path / "aln.fa"
        p.write_text(self.ALN)
        residsA = np.array([101, 102, 103, 104, 105])
        residsB = np.array([201, 202, 203, 204, 205])
        tausA = np.array([[101, 10.0], [102, 5.0], [103, 2.0], [105, 7.0]])
        tausB = np.array([[201, 8.0], [202, 1.0], [203, 2.0], [205, 4.0]])
        a, b, dt = delta_tau(str(p), residsA, residsB, tausA, tausB)
        assert np.array_equal(a, [101, 102, 103, 105])
        assert np.array_equal(b, [201, 202, 203, 205])
        assert np.allclose(dt, [2.0, 4.0, 0.0, 3.0])


class TestDiagnostics:
    def test_rhat_converged_vs_not(self, rng):
        from basicrta_tpu.ops.diagnostics import split_rhat
        good = rng.normal(0, 1, (4, 500, 3))
        r = split_rhat(good)
        assert np.all(r < 1.05)
        bad = good.copy()
        bad[0] += 5.0  # one chain stuck elsewhere
        assert np.all(split_rhat(bad) > 1.5)

    def test_ess(self, rng):
        from basicrta_tpu.ops.diagnostics import \
            effective_sample_size
        iid = rng.normal(0, 1, (2, 400, 1))
        ess = effective_sample_size(iid)
        assert 400 < ess[0] <= 1000  # ~ c*n for iid
        # strongly autocorrelated chain -> small ESS
        ar = np.cumsum(rng.normal(0, 1, (2, 400, 1)), axis=1)
        assert effective_sample_size(ar)[0] < 100

    def test_chain_report(self, rng):
        from basicrta_tpu.ops.diagnostics import chain_report
        W = rng.dirichlet(np.ones(4), (3, 200)).reshape(3, 200, 4)
        R = rng.gamma(2.0, size=(3, 200, 4))
        rep = chain_report(W, R, burnin_samples=20)
        assert rep["rhat_weights"].shape == (4,)
        assert np.all(rep["rhat_rates"] < 1.1)


class TestDeferredPipeline:
    """Cross-bucket pipelining (run_batch defer_transfer / finalize_batch /
    run_residues dispatch-all-then-finalize)."""

    @pytest.mark.slow
    def test_deferred_equals_eager(self, rng):
        from basicrta_tpu.sampler.batch import (bucket_residues,
                                                finalize_batch, run_batch)
        x = discretize_times(simulate_hyperexp(
            1200, [0.8, 0.2], [2.0, 0.1], rng), 0.1)
        batch = bucket_residues({"A1": x, "B2": x[:300]}, floor=1024)[0]
        cfg = GibbsConfig(ncomp=4, niter=300, g=10, seed=3)
        eager = run_batch(batch, cfg)
        deferred = finalize_batch(run_batch(batch, cfg, defer_transfer=True))
        np.testing.assert_array_equal(eager.mcweights, deferred.mcweights)
        np.testing.assert_array_equal(eager.mcrates, deferred.mcrates)
        assert eager.names == deferred.names
        # finalize of an already-final result is the identity
        assert finalize_batch(eager) is eager

    @pytest.mark.slow
    def test_run_residues_multibucket_deferred(self, rng):
        """Residues spanning several ladder buckets through the pipelined
        driver; per-residue results must match single-bucket runs."""
        from basicrta_tpu.sampler.batch import (bucket_residues,
                                                finalize_batch, run_batch,
                                                run_residues)
        times = {
            "A1": discretize_times(simulate_hyperexp(
                400, [0.8, 0.2], [2.0, 0.1], rng), 0.1),
            "B2": discretize_times(simulate_hyperexp(
                6000, [0.7, 0.3], [3.0, 0.2], rng), 0.02),
        }
        cfg = GibbsConfig(ncomp=4, niter=300, g=10, seed=5)
        out = run_residues(times, cfg)
        assert set(out) == {"A1", "B2"}
        for name in out:
            W, R = out[name]
            assert W.shape == (1, 30, 4) and np.isfinite(W).all()
            # same residue alone reproduces the pipelined result exactly
            # (lane streams are salted by the bucket's residue-name set,
            # and run_residues names lanes '<residue>#<chain>')
            solo = finalize_batch(run_batch(
                bucket_residues({f"{name}#0": times[name]})[0], cfg,
                defer_transfer=True))
            np.testing.assert_array_equal(solo.mcweights[0], W[0])

    @pytest.mark.slow
    def test_run_residues_rejects_duplicate_defer_kwarg(self, rng):
        from basicrta_tpu.sampler.batch import run_residues
        x = discretize_times(simulate_hyperexp(
            300, [0.8, 0.2], [2.0, 0.1], rng), 0.1)
        cfg = GibbsConfig(ncomp=3, niter=100, g=10)
        # pipelining is managed internally; the kwarg is absorbed, not
        # forwarded into a TypeError
        out = run_residues({"A1": x}, cfg, defer_transfer=False)
        assert "A1" in out


@pytest.mark.slow
def test_engine_specific_ladder(rng):
    """Both engines run the same power-of-two value ladder and produce
    identically shaped results for every residue."""
    from basicrta_tpu.sampler.batch import bucket_residues
    residues = {f"R{i}": 0.1 * rng.integers(1, 40 + 60 * i, 300)
                for i in range(6)}
    buckets = bucket_residues(residues)
    assert all(b.values.shape[1] in (128, 256, 512, 1024) for b in buckets)
    from basicrta_tpu.config import GibbsConfig
    from basicrta_tpu.sampler.batch import run_residues
    cfg = GibbsConfig(ncomp=3, niter=100, g=10)
    out_x = run_residues(residues, cfg, engine="xla")
    out_p = run_residues(residues, cfg, engine="pallas", interpret=True)
    assert set(out_x) == set(out_p) == set(residues)
    for name in residues:
        assert out_x[name][0].shape == out_p[name][0].shape
