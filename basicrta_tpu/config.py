"""Centralized configuration.

The reference scatters its constants through the code (defaults at reference
gibbs.py:133-141, gibbs.py:144, gibbs.py:173-174, gibbs.py:285-286,
gibbs.py:296, contacts.py:51-52, kinetics.py:167-168). Here every knob lives
in one typed, hashable config object so it can be closed over by jitted
functions and serialized next to artifacts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Configuration of the exponential-mixture Gibbs sampler.

    Defaults reproduce the reference exactly:

    - ``ncomp=15`` mixture components, ``niter=110000`` sweeps
      (reference gibbs.py:133).
    - thinning interval ``g=100``, burn-in 10,000 sweeps
      (reference gibbs.py:140-141).
    - Dirichlet prior ``alpha = 1/ncomp`` per component
      (reference gibbs.py:173).
    - Gamma prior shape ``a=1``, rate ``b=3`` on component rates
      (reference gibbs.py:174).
    - noise-cluster indicator cutoff 0.4 (reference gibbs.py:144).
    - weight cutoff rule ``wcutoff = weight_cut_events / N`` with
      ``weight_cut_events=10`` (reference gibbs.py:285-286).
    - Gaussian-mixture clustering restarts ``gmm_n_init=117``
      (reference gibbs.py:296).
    """

    ncomp: int = 15
    niter: int = 110_000
    g: int = 100                      # thinning interval
    burnin: int = 10_000              # sweeps discarded before analysis
    alpha: Optional[float] = None     # Dirichlet prior; None -> 1/ncomp
    gamma_shape: float = 1.0          # Gamma prior shape a
    gamma_rate: float = 3.0           # Gamma prior rate b
    noise_cutoff: float = 0.4         # pindicator max below this -> noise
    weight_cut_events: float = 10.0   # wcutoff = weight_cut_events / N
    gmm_n_init: int = 117             # GMM restarts during clustering
    gmm_max_iter: int = 100           # EM iterations per restart
    gmm_tol: float = 1e-3             # EM convergence tolerance
    # Independent chains per residue. The LIBRARY default is 1 — exact
    # reference semantics (the reference runs one chain per residue,
    # gibbs.py:191) so `Gibbs(x).run()` matches it sample-for-sample in
    # distribution. The shipping CLI default is 2 (`--nchains`,
    # cli.py): production runs want split-R-hat/ESS convergence
    # diagnostics, which need >= 2 chains; each chain is one more
    # lane of the batched sampler (bench.py agg_sweeps_2chain /
    # two_chain_cost measure the shipping default; docs/design.md
    # "Multi-chain production default").
    n_chains: int = 1
    seed: int = 0

    @property
    def n_samples(self) -> int:
        """Number of thinned posterior samples kept per chain.

        The reference allocates ``(niter+1)//g`` rows (gibbs.py:167-170) but
        only ever writes ``niter//g`` of them (saves at sweeps g, 2g, ...,
        niter; gibbs.py:214-217); we keep exactly the written rows.
        """
        return self.niter // self.g

    @property
    def burnin_samples(self) -> int:
        return self.burnin // self.g

    @property
    def alpha_eff(self) -> float:
        return (1.0 / self.ncomp) if self.alpha is None else self.alpha

    def wcutoff(self, n_events: int) -> float:
        return self.weight_cut_events / float(n_events)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "GibbsConfig":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """Configuration of contact-map extraction and event merging.

    Defaults reproduce the reference: primary (map) cutoff 10.0 A
    (reference contacts.py:51), analysis cutoff typically 7.0 A
    (reference docs/source/tutorial.rst, scripts/setup.py:6), and trajectory
    chunking as a memory valve (reference contacts.py:52 uses 100 slices; we
    express it as frames per device batch instead).
    """

    map_cutoff: float = 10.0     # primary contact-map cutoff [A]
    cutoff: float = 7.0          # analysis cutoff imposed on the map [A]
    frames_per_batch: int = 32   # trajectory frames per device batch
    # per-frame capacity of the device-compacted contact transfer; frames
    # with more sub-cutoff pairs trigger an exact dense-transfer fallback
    transfer_cap: int = 2048
    use_pbc: bool = True         # minimum-image convention (orthorhombic)
    # bounding-sphere prefilter: skip residue pairs whose centroid-distance
    # lower bound clears the map cutoff (exact — see distances.min_dist_
    # pruned). 'auto' enables it when the dense kernel's per-frame atom-
    # pair count crosses prefilter_auto_pairs; True/False force it.
    prefilter: object = "auto"
    # dense-vs-prefilter crossover (atom pairs/frame). The dense kernel
    # already bounds transients by chunking R1, so this is a pure speed
    # heuristic: the 2026-08-19 interleaved A/B (scripts/cbench.py, 48M
    # pairs/frame membrane workload) measured dense 54.9 f/s vs pruned
    # 44.1-52.4 f/s — the gather/compaction overhead only pays off well
    # past that scale (e.g. a 100k-atom membrane is ~480M pairs/frame).
    # per-frame packing capacity for plausible residue pairs. The exact
    # atom sweep and the device->host transfer scale with the cap, so the
    # mapper ADAPTS it: batches run at the smallest power-of-two cap that
    # held every frame so far (x1.25 margin, floor prefilter_cap_min), a
    # frame overflowing the current cap is redone at the exact fit, and
    # prefilter_cap is the ceiling past which the batch falls back to the
    # dense kernel (exactness is guarded at every step; the ceiling is
    # sized so a 100k-atom bilayer's ~5k plausible pairs/frame never hit
    # the dense fallback). Set prefilter_cap_min == prefilter_cap to pin
    # a static cap (benchmarks).
    prefilter_cap: int = 32768
    prefilter_cap_min: int = 256
    prefilter_auto_pairs: int = 128_000_000
    # coordinate wire format for the host->device upload: 'f32' (exact)
    # or 'u16' — per-frame affine quantization onto the 16-bit grid
    # spanning each axis's coordinate extent, HALVING upload bytes for a
    # coordinate error <= extent/65535/2 (~0.002 A at a 240 A box; XTC
    # trajectories natively store a 0.01 A grid, so u16 adds nothing to
    # their error budget). The affine offset preserves residue locality
    # (no wrap into [0, box)), so the pruned kernel sees the same
    # bounding spheres; works with any box geometry or none. The CLI
    # picks 'u16' automatically for XTC-only inputs.
    upload_dtype: str = "f32"
    # host-memory valve: accumulated contact rows spill to an on-disk
    # memmap past this budget (the reference's nslices memory valve,
    # contacts.py:45-48, at device speed); 0 disables spilling
    host_row_budget: int = 8_000_000

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ContactConfig":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class DensityConfig:
    """Weighted-density grid configuration (reference kinetics.py:167-168:
    40x40x40 A box, delta=1.0 A per wdensity.py:183)."""

    xdim: float = 40.0
    ydim: float = 40.0
    zdim: float = 40.0
    delta: float = 1.0
    padding: float = 2.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "DensityConfig":
        return cls(**json.loads(s))
