"""High-level per-residue Gibbs sampler driver.

API-parity layer over the jitted kernels, mirroring the reference ``Gibbs``
class surface (reference gibbs.py:91-381): construct with residence times,
``run()`` the sampler, ``process_gibbs()`` the posterior, ``estimate_tau()``
the slowest process, ``save()``/``load()`` artifacts. Differences by design:

- results persist as NPZ + JSON metadata under the same
  ``basicrta-{cutoff}/{residue}/`` tree (no pickled class instances,
  cf. gibbs.py:336-381);
- multiple chains per residue are supported (``cfg.n_chains``);
- the per-event indicator is not stored during sampling; membership
  probabilities are regenerated conditionally during post-processing
  (sanctioned by the reference's ``_sample_indicator``, gibbs.py:321-334).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from basicrta_tpu.config import GibbsConfig
from basicrta_tpu.ops.surv import infer_timestep, survival_function
from basicrta_tpu.postprocess.clustering import process_samples, ClusterResult
from basicrta_tpu.postprocess.tau import (estimate_params, estimate_tau,
                                          AllNoiseError)
from basicrta_tpu.sampler.kernels import (compute_tiers, dedup_times,
                                           run_chains)


class Gibbs:
    """Gibbs sampler for the exponential mixture of one residue's times.

    Example (mirrors reference gibbs.py:112-120)::

        g = Gibbs(times, residue='W313', cutoff=7.0)
        g.run()
        g.process_gibbs()
        lo, tau, hi = g.estimate_tau()
    """

    def __init__(self, times: Optional[np.ndarray] = None,
                 residue: Optional[str] = None, cutoff: Optional[float] = None,
                 cfg: GibbsConfig = GibbsConfig(), root: str = "."):
        self.cfg = cfg
        self.residue = residue
        self.cutoff = cutoff
        self.root = root
        self.times = None if times is None else np.asarray(times, np.float64)
        self.ts = infer_timestep(self.times) if times is not None else None
        self.mcweights: Optional[np.ndarray] = None  # (chains, S, K)
        self.mcrates: Optional[np.ndarray] = None
        self.t = self.s = None
        self.processed: Optional[ClusterResult] = None
        self.parameters = None          # (lmode, 2) point estimates
        self.intervals = None           # (2, lmode, 2) CIs
        self.tau = None                 # (lo, max, hi)
        if self.times is not None:
            self.t, self.s = survival_function(self.times, self.ts)
            self._values, self._counts = dedup_times(self.times)

    def __getitem__(self, item):
        """Attribute access by name (reference gibbs.py:159-160)."""
        return getattr(self, item)

    # ------------------------------------------------------------------ #
    def _residue_fold(self) -> int:
        """Stable per-residue PRNG fold-in. Python's ``hash(str)`` is salted
        per process (PYTHONHASHSEED), which would make chains and all
        post-processing differ between runs of the same cfg.seed."""
        return zlib.crc32(str(self.residue).encode()) & 0x7FFFFFFF

    @property
    def savedir(self) -> str:
        return os.path.join(self.root, f"basicrta-{self.cutoff}",
                            str(self.residue))

    def run(self, mode: str = "auto", save: bool = True) -> "Gibbs":
        """Execute the sampler (reference gibbs.py:176-219).

        Modes: 'pallas' (the fused segment kernel; NVIDIA GPUs only),
        'collapsed' (deduplicated XLA path), 'dense' (literal per-event
        sampler), or 'auto' (pallas on a GPU, collapsed elsewhere).
        """
        if mode == "auto":
            from basicrta_tpu.sampler.batch import resolve_engine
            mode = ("pallas" if resolve_engine("auto") == "pallas"
                    else "collapsed")
        if mode == "pallas":
            from basicrta_tpu.sampler.batch import run_residues
            samples = run_residues({str(self.residue): self.times},
                                   self.cfg, n_chains=self.cfg.n_chains,
                                   engine="pallas")
            W, R = samples[str(self.residue)]
            self.mcweights, self.mcrates = W, R
            if save:
                self.save()
            return self
        key = jax.random.fold_in(jax.random.key(self.cfg.seed),
                                 self._residue_fold())
        tiers = None
        if mode == "collapsed":
            # multiplicity-descending order enables the tiered sampler; the
            # thinned (weights, rates) outputs are order-invariant
            order, tiers = compute_tiers(self._counts)
            data = jnp.asarray(self._values[order], jnp.float32)
            aux = jnp.asarray(self._counts[order], jnp.float32)
        else:
            data = jnp.asarray(self.times, jnp.float32)
            aux = None
        W, R = run_chains(key, data, aux, self.cfg, mode,
                          n_chains=self.cfg.n_chains, tiers=tiers)
        self.mcweights = np.asarray(W)
        self.mcrates = np.asarray(R)
        if save:
            self.save()
        return self

    # ------------------------------------------------------------------ #
    def process_gibbs(self, chain=0, save: bool = True) -> "Gibbs":
        """Posterior filtering, clustering, and parameter estimation
        (reference gibbs.py:275-308).

        ``chain`` selects one chain by index or pools post-burn-in samples
        from all chains with ``chain='pooled'`` (a multi-chain upgrade; the
        reference runs a single chain).
        """
        key = jax.random.fold_in(jax.random.key(self.cfg.seed + 1),
                                 self._residue_fold())
        if chain == "pooled" and self.mcweights.shape[0] > 1:
            b = self.cfg.burnin_samples
            # keep a burn-in-sized prefix so process_samples' burn-in
            # discard leaves exactly the pooled post-burn-in samples
            W = np.concatenate([self.mcweights[0][:b]]
                               + [c[b:] for c in self.mcweights])
            R = np.concatenate([self.mcrates[0][:b]]
                               + [c[b:] for c in self.mcrates])
        else:
            idx = 0 if chain == "pooled" else chain
            W, R = self.mcweights[idx], self.mcrates[idx]
        self.processed = process_samples(
            key, W, R, self._values, self._counts, self.cfg)
        self.parameters, self.intervals = estimate_params(self.processed)
        if save:
            self.save()
        return self

    def estimate_tau(self):
        """(ci_lo, tau_max, ci_hi) of the slowest non-noise process
        (reference gibbs.py:691-715)."""
        if self.processed is None:
            self.process_gibbs()
        self.tau = estimate_tau(self.processed, self.cfg.noise_cutoff,
                                self.parameters)
        return list(self.tau)

    def estimate_tau_all(self):
        """tau + 95% CI rows ``[cluster, ci_lo, tau_max, ci_hi]`` for every
        non-noise cluster, slowest first (the reference declares this as
        future work in its estimate_tau docstring, gibbs.py:693-698)."""
        from basicrta_tpu.postprocess.tau import estimate_tau_all
        if self.processed is None:
            self.process_gibbs()
        return estimate_tau_all(self.processed, self.cfg.noise_cutoff,
                                self.parameters)

    def diagnostics(self) -> dict:
        """Convergence diagnostics over the thinned chains: split-R̂ and
        bulk ESS of the live components' weights and log-rates (a
        multi-chain capability upgrade — the reference runs one chain with
        no convergence checking, gibbs.py:191). Most informative with
        ``cfg.n_chains > 1``; with one chain the split halves still detect
        within-chain drift."""
        from basicrta_tpu.ops.diagnostics import convergence_report
        return convergence_report(
            self.mcweights, self.mcrates,
            burnin_samples=self.cfg.burnin_samples,
            wcutoff=self.cfg.wcutoff(len(self.times)))

    def pindicator_per_event(self) -> np.ndarray:
        """(N, lmode) membership probabilities broadcast from unique values
        back to events (rows of equal residence time are exchangeable)."""
        if self.processed is None:   # e.g. chains imported from a
            self.process_gibbs()     # reference pickle (io/legacy.py)
        pv = self.processed.pindicator_values
        idx = np.searchsorted(self._values, self.times)
        return pv[idx]

    # ------------------------------------------------------------------ #
    def save(self) -> str:
        """Persist raw + processed state as NPZ (+ ``.bak`` rotation,
        matching reference gibbs.py:336-349)."""
        os.makedirs(self.savedir, exist_ok=True)
        path = os.path.join(self.savedir, f"gibbs_{self.cfg.niter}.npz")
        if os.path.exists(path):
            os.replace(path, path + ".bak")
        arrays = {
            "times": self.times,
            "mcweights": self.mcweights if self.mcweights is not None
            else np.zeros(0),
            "mcrates": self.mcrates if self.mcrates is not None
            else np.zeros(0),
        }
        if self.processed is not None:
            p = self.processed
            arrays.update(
                proc_labels=p.labels, proc_data=p.data,
                proc_inds_row=p.inds[0], proc_inds_col=p.inds[1],
                proc_pindicator=p.pindicator_values,
                proc_presorts=p.presorts,
                parameters=self.parameters, intervals=self.intervals)
            if self.tau is not None:
                arrays["tau"] = np.asarray(self.tau)
        meta = {"residue": self.residue, "cutoff": self.cutoff,
                "ts": self.ts, "cfg": self.cfg.to_json(),
                "lmode": None if self.processed is None
                else int(self.processed.lmode)}
        np.savez_compressed(path, _meta=json.dumps(meta), **arrays)
        return path

    @classmethod
    def load(cls, path: str) -> "Gibbs":
        """Rehydrate from :meth:`save` output (reference gibbs.py:351-381).

        A reference-package ``gibbs_{niter}.pkl`` loads too (chains +
        configuration; re-run :meth:`process_gibbs` for processed state) —
        see :mod:`basicrta_tpu.io.legacy`.
        """
        if path.endswith(".pkl"):
            from basicrta_tpu.io.legacy import load_reference_gibbs
            return load_reference_gibbs(
                path, root=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(path)))))
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["_meta"]))
            g = cls(times=z["times"], residue=meta["residue"],
                    cutoff=meta["cutoff"], cfg=GibbsConfig.from_json(
                        meta["cfg"]),
                    root=os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(path)))))
            if z["mcweights"].size:
                g.mcweights = z["mcweights"]
                g.mcrates = z["mcrates"]
            if "proc_labels" in z:
                g.processed = ClusterResult(
                    lmode=meta["lmode"], labels=z["proc_labels"],
                    inds=(z["proc_inds_row"], z["proc_inds_col"]),
                    data=z["proc_data"],
                    pindicator_values=z["proc_pindicator"],
                    presorts=z["proc_presorts"])
                g.parameters = z["parameters"]
                g.intervals = z["intervals"]
            if "tau" in z:
                g.tau = tuple(z["tau"])
        return g


    # ------------------------------------------------------------------ #
    # plotting / reprocessing surface mirroring the reference Gibbs class
    def cluster(self, chain=0, method: str = "GaussianMixture",
                **kwargs) -> "Gibbs":
        """Re-run posterior clustering only (reference gibbs.py:221-273).

        ``method`` mirrors the reference's sklearn.mixture dispatch
        (gibbs.py:229-232): 'GaussianMixture' uses the built-in JAX EM;
        other names (e.g. 'BayesianGaussianMixture') delegate to sklearn
        when it is installed. Remaining kwargs override GibbsConfig fields
        (e.g. gmm_n_init).
        """
        if method != "GaussianMixture":
            return self._cluster_sklearn(chain, method, **kwargs)
        if kwargs:
            import dataclasses as _dc
            self.cfg = _dc.replace(self.cfg, **kwargs)
        return self.process_gibbs(chain=chain, save=False)

    def _cluster_sklearn(self, chain, method, **kwargs):
        """Label surviving posterior pairs with an sklearn.mixture model,
        then rebuild membership/sorting with the standard pipeline."""
        from sklearn import mixture
        from basicrta_tpu.postprocess.clustering import (
            ClusterResult, _label_matrix, accumulate_cluster_votes,
            component_counts, gather_cluster_data, select_lmode,
            sort_labels_by_rate)
        idx = 0 if chain == "pooled" else chain
        b = self.cfg.burnin_samples
        W = np.asarray(self.mcweights[idx])[b:]
        R = np.asarray(self.mcrates[idx])[b:]
        wcut = self.cfg.wcutoff(len(self.times))
        lens = component_counts(W, wcut)
        lmode = select_lmode(lens)
        data, inds, train = gather_cluster_data(W, R, wcut, lmode)
        clu = getattr(mixture, method)(
            n_components=lmode,
            **{k: v for k, v in kwargs.items() if k != "n_components"})
        clu.fit(np.log(train))
        labels = clu.predict(np.log(data)).astype(np.int32)
        res = ClusterResult(lmode=lmode, labels=labels, inds=inds,
                            data=data)
        L = _label_matrix(inds, labels, W.shape)
        votes = accumulate_cluster_votes(
            jax.random.key(self.cfg.seed + 2), W, R, self._values,
            self._counts, L, lmode)
        denom = votes.sum(axis=1, keepdims=True)
        res.pindicator_values = votes / np.maximum(denom, 1e-30)
        self.processed = sort_labels_by_rate(res, self.cfg.noise_cutoff)
        from basicrta_tpu.postprocess.tau import estimate_params
        self.parameters, self.intervals = estimate_params(self.processed)
        return self

    def result_plot(self, **kwargs):
        """Cluster scatter figure (reference gibbs.py:310-319)."""
        from basicrta_tpu.plots import plot_cluster_scatter
        return plot_cluster_scatter(self, **kwargs)

    def plot_surv(self, **kwargs):
        """Survival function with mixture components
        (reference gibbs.py:717-778)."""
        from basicrta_tpu.plots import plot_surv
        return plot_surv(self, **kwargs)

    def plot_gibbs(self, **kwargs):
        """Thinned traces (reference gibbs.py:640-665)."""
        from basicrta_tpu.plots import plot_gibbs_traces
        return plot_gibbs_traces(self, **kwargs)

    def plot_hist(self, **kwargs):
        """Posterior histograms per cluster (reference gibbs.py:427-638)."""
        from basicrta_tpu.plots import plot_hist_results
        return plot_hist_results(self, **kwargs)

    def plot_tau_hist(self, **kwargs):
        """Tau histogram of the slowest cluster
        (reference gibbs.py:383-425)."""
        from basicrta_tpu.plots import plot_tau_hist
        return plot_tau_hist(self, **kwargs)

    def mixture_and_plot(self, **kwargs):
        """Train/validate/all clustering diagnostic figure sets
        (reference util.py:694-1198)."""
        from basicrta_tpu.plots import mixture_and_plot
        return mixture_and_plot(self, **kwargs)

    def make_residue_plots(self, comps=None):
        """Point-estimate fits, posterior histograms, and traces
        (reference util.py:384-400)."""
        from basicrta_tpu.plots import make_residue_plots
        return make_residue_plots(self, comps)


def run_residue(times, residue, cutoff, cfg: GibbsConfig = GibbsConfig(),
                root: str = ".", mode: str = "collapsed") -> Gibbs:
    """Construct, run, and post-process one residue (the unit of work the
    reference fans out per process; util.py:475-485)."""
    g = Gibbs(times, residue=residue, cutoff=cutoff, cfg=cfg, root=root)
    g.run(mode=mode)
    g.process_gibbs()
    try:
        g.estimate_tau()
    except AllNoiseError:
        g.tau = (0.0, 0.0, 0.0)
    g.save()
    return g
