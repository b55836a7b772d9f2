"""basicrta_tpu — accelerator-native Bayesian single-cutoff residence-time
analysis.

A ground-up JAX/XLA/Pallas re-design of the capabilities of ``basicrta``
(Sexton et al. 2024, bioRxiv 10.1101/2024.11.07.622502): contact-map
extraction from MD trajectories, per-residue exponential-mixture Gibbs
sampling, posterior clustering and residence-time (tau) estimation, kinetic
mapping, and posterior-weighted density rendering.

Architecture (device-first, functional):

- ``basicrta_tpu.sampler``   — the exponential-mixture Gibbs sampler as a
  jitted, thinned ``lax.scan`` sweep kernel, vmappable over chains and
  residues and shardable over a device mesh (replaces the reference's
  one-process-per-residue multiprocessing/Slurm fan-out,
  cf. reference gibbs.py:91-219, gibbs.py:20-88).
- ``basicrta_tpu.postprocess`` — burn-in/weight filtering, JAX EM Gaussian-
  mixture clustering of posterior samples, label sorting/noise detection and
  tau credible intervals (cf. reference gibbs.py:221-308, util.py:694-1198).
- ``basicrta_tpu.contacts``  — batched pairwise-distance contact detection on
  device plus vectorized residence-event merging (cf. reference
  contacts.py:17-231).
- ``basicrta_tpu.kinetics``  — posterior-probability frame expansion and
  weighted 3D densities as device scatter-adds (cf. reference kinetics.py,
  wdensity.py, pwdensity.py).
- ``basicrta_tpu.parallel``  — mesh construction and sharded drivers.
- ``basicrta_tpu.io``        — NPZ artifact persistence and MD file formats
  (GRO/PDB topologies, XTC/DCD trajectories, OpenDX densities) with no
  dependency on MDAnalysis/gridData.
"""

__version__ = "0.3.0"

from basicrta_tpu.config import GibbsConfig, ContactConfig

__all__ = ["GibbsConfig", "ContactConfig", "__version__"]
