"""chip_smoke.py's phases at tiny sizes on the CPU (the full-size run
needs the card), and its refusal to run without a GPU."""

import os

import numpy as np
import pytest

import chip_smoke as cs


def test_refuses_without_gpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU" in out.err and out.out == ""


def test_functionals_and_law_check():
    rng = np.random.default_rng(0)
    W = rng.dirichlet([1.0, 1.0], (2, 50))
    R = rng.uniform(0.5, 2.0, (2, 50, 2))
    f = cs.functionals(W, R, (0.5, 1.0), 4.0)
    assert f.shape == (2, 50, 3) and np.all((f[..., :2] > 0)
                                            & (f[..., :2] < 1))
    ok, ma, mb, z = cs.agree_in_law(f, f)
    assert ok and np.all(z == 0)
    ok, *_ = cs.agree_in_law(f, f + 1.0)
    assert not ok


@pytest.fixture(scope="module")
def sampled():
    rec = {}
    run = cs.phase_sampler(rec, n_residues=2, niter=200, g=10)
    return rec, run


def test_phase_sampler_tiny(sampled):
    rec, (residues, samples, cfg) = sampled
    assert rec["ok"]
    assert set(samples) == set(residues)
    assert samples["R0"][0].shape == (2, 20, cs.NCOMP)
    assert rec["agg_sweeps_per_s_2chain"] > 0


def test_phase_post_tiny(sampled):
    _, (residues, samples, cfg) = sampled
    rec = {}
    cs.phase_post(rec, residues, samples, cfg, n_cpu=1)
    assert rec["ok"]


def test_phase_contacts_tiny(tmp_path):
    rec = {}
    cs.phase_contacts(rec, str(tmp_path), n_frames=2, n_tric=1)
    assert rec["ok"] and rec["contacts_frames_per_s_u16"] > 0


def test_phase_cli_tiny(tmp_path):
    # 3,000 sweeps are too few for the coverage requirement; this checks
    # the four stages, the coverage bookkeeping and the density check
    rec = {}
    cs.phase_cli(rec, str(tmp_path), frames=1500, nprot=6, nlip=6,
                 niter=3000, min_cover=0.0)
    assert rec["ok"]
    assert os.path.exists(tmp_path / "tausout.npy")


def test_phase_four_tiny(tmp_path):
    # 200 sweeps are far too few for the 4-sigma law check, so only the
    # exact comparisons are held to their limits here
    rec = {}
    cs.phase_four(rec, str(tmp_path), n_residues=2, niter=200, g=10,
                  interpret=True, n_frames=2, n_sigma=1e9)
    assert rec["ok"]
