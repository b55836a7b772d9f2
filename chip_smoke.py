#!/usr/bin/env python
"""Smoke test of the whole pipeline on NVIDIA GPUs.

Drives contacts -> gibbs -> cluster -> kinetics through the entry points a
user calls, at full widths, and checks every result against a plain
reference:

- sampler: the 300-residue workload (K=15, g=100, a 446,605-event
  flagship lane) through ``run_residues`` with 2 chains for one
  10,000-sweep production segment on the engine ``auto`` picks; weights
  finite and normalized; the flagship lane equal in law to the XLA engine
  on the same card (label-invariant functionals within 4 Monte Carlo
  standard errors);
- post-processing: ``process_residues_batched`` on the card and on the
  CPU backend of the same process, tau and its credible interval compared;
- contacts: the 101,400-atom bilayer written as XTC, mapped with both
  upload formats, plus one triclinic batch at membrane scale, each
  compared row by row with the cKDTree replica of the reference;
- CLI: the four CLI stages in process on a system with planted kinetics;
  the tau credible intervals must cover the slowest true tau, and the
  weighted density must match a numpy histogramdd.

``--four`` runs only the multi-device paths (lane-sharded sampling,
event-sharded flagship, frame-sharded contacts and densities) on four
GPUs, each against its one-device counterpart.

Usage:
    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --four    # four GPUs, the multi-device paths

Without a GPU it exits non-zero before any phase. The last line of stdout
is one JSON object ``{"ok": true, "device": {...}}``; everything else is
printed on earlier lines.
"""

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from basicrta_tpu.jax_cache import enable_compilation_cache  # noqa: E402

NCOMP = 15
G = 100
SWEEPS = 10_000          # one production segment (100 blocks of g=100)
SLOW_TAU_NS = 5.0        # slowest planted tau of the CLI system (1/0.2)


def log(*args):
    print(*args, flush=True)


def card_info() -> str:
    """The card's name and power limit, read by nvidia-smi in a child
    process that does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


class _Compiles:
    """Sums XLA backend compile time (jax.monitoring events)."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


_COMPILES = None


@contextlib.contextmanager
def phase(name: str, results: dict):
    """Time a phase (host clock) and record wall, compile seconds and the
    device's peak bytes in use; a raised exception fails the phase."""
    import jax
    c0 = _COMPILES.total if _COMPILES else 0.0
    t0 = time.time()
    rec = {"ok": False}
    results[name] = rec
    log(f"=== phase {name}")
    try:
        yield rec
    except Exception as e:  # noqa: BLE001 — reported, fails the run
        import traceback
        traceback.print_exc()
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
    stats = jax.devices()[0].memory_stats() or {}
    rec["wall_s"] = time.time() - t0
    rec["compile_s"] = (_COMPILES.total if _COMPILES else 0.0) - c0
    rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"--- phase {name}: {'ok' if rec['ok'] else 'FAILED'}  "
        f"wall {rec['wall_s']:.2f} s  compile {rec['compile_s']:.2f} s  "
        f"peak_bytes_in_use {rec['peak_bytes_in_use']} (process so far)")


# ---------------------------------------------------------------- sampler
def functionals(W, R, ts, t_max):
    """Label-invariant per-sample functionals of the mixture: the survival
    function S(t) = sum_k w_k exp(-r_k t) at each t in ``ts`` and the
    restricted mean residence time int_0^t_max S(t) dt. W, R: (chains,
    S, K). Returns (chains, S, len(ts) + 1)."""
    W = np.asarray(W, np.float64)
    R = np.asarray(R, np.float64)
    cols = [np.sum(W * np.exp(-R * t), -1) for t in ts]
    cols.append(np.sum(W * -np.expm1(-R * t_max) / R, -1))
    return np.stack(cols, -1)


def agree_in_law(a, b, n_sigma=4.0):
    """Compare posterior means of (chains, S, F) functional draws a and b:
    |mean_a - mean_b| <= n_sigma * sqrt(mcse_a^2 + mcse_b^2), with the
    Monte Carlo standard error sd / sqrt(ESS) of each run."""
    from basicrta_tpu.ops.diagnostics import effective_sample_size
    out = []
    for x in (a, b):
        ess = effective_sample_size(x)
        sd = x.reshape(-1, x.shape[-1]).std(0)
        out.append((x.reshape(-1, x.shape[-1]).mean(0),
                    sd / np.sqrt(np.maximum(ess, 1.0))))
    (ma, sa), (mb, sb) = out
    z = np.abs(ma - mb) / np.maximum(np.hypot(sa, sb), 1e-12)
    return bool(np.all(z <= n_sigma)), ma, mb, z


def law_check(label, W, R, Wref, Rref, times, burnin, n_sigma=4.0):
    """Print and return the in-law comparison of two runs of one lane."""
    ts = tuple(float(np.quantile(times, q)) for q in (0.5, 0.9, 0.99))
    fa = functionals(W[:, burnin:], R[:, burnin:], ts, float(times.max()))
    fb = functionals(Wref[:, burnin:], Rref[:, burnin:], ts,
                     float(times.max()))
    ok, ma, mb, z = agree_in_law(fa, fb, n_sigma)
    names = [f"S({t:g})" for t in ts] + ["restricted mean"]
    for n, x, y, zz in zip(names, ma, mb, z):
        log(f"  {label} {n}: {x:.6g} vs reference {y:.6g}  "
            f"|z| = {zz:.2f} (limit {n_sigma})")
    return ok


def phase_sampler(rec, n_residues=300, niter=SWEEPS, g=G, nchains=2):
    """The batched sampler through run_residues on the engine ``auto``
    picks, against the XLA engine; returns the samples."""
    import bench
    from basicrta_tpu.config import GibbsConfig
    from basicrta_tpu.sampler.batch import resolve_engine, run_residues

    engine = resolve_engine("auto")
    residues = bench.make_workload(n_residues)
    cfg = GibbsConfig(ncomp=NCOMP, niter=niter, g=g,
                      burnin=max(g, niter // 10), n_chains=nchains)
    log(f"  {n_residues} residues x {nchains} chains, {niter} sweeps, "
        f"engine {engine}; flagship lane {len(residues['R0'])} events")
    out = run_residues(residues, cfg, n_chains=nchains, engine=engine)
    ok = True
    for name, (W, R) in out.items():
        if not (np.all(np.isfinite(W)) and np.all(np.isfinite(R))
                and np.allclose(W.sum(-1), 1.0, atol=1e-4)):
            log(f"  {name}: non-finite or unnormalized weights")
            ok = False
    log(f"  weights finite and normalized for all {len(out)} residues: "
        f"{ok}")

    ref = run_residues({"R0": residues["R0"]}, cfg, n_chains=nchains,
                       engine="xla")
    law_ok = law_check("flagship", *out["R0"], *ref["R0"],
                       residues["R0"], cfg.burnin_samples)
    log(f"  flagship ({engine}) vs xla engine in law: {law_ok}")
    ok = ok and law_ok

    for ch in (1, 2):
        run_residues(residues, cfg, n_chains=ch, engine=engine)   # warm
        t0 = time.time()
        run_residues(residues, cfg, n_chains=ch, engine=engine)
        dt = time.time() - t0
        rec[f"agg_sweeps_per_s_{ch}chain"] = n_residues * ch * niter / dt
        log(f"  TIMING aggregate sweeps/s, {ch} chain(s): "
            f"{n_residues * ch * niter / dt:.1f} ({dt:.3f} s)")
    fl = {"R0": residues["R0"]}
    run_residues(fl, cfg, n_chains=1, engine=engine)
    t0 = time.time()
    run_residues(fl, cfg, n_chains=1, engine=engine)
    dt = time.time() - t0
    rec["flagship_sweeps_per_s"] = niter / dt
    log(f"  TIMING flagship sweeps/s: {niter / dt:.1f}")
    rec["ok"] = ok
    return residues, out, cfg


# ------------------------------------------------------- post-processing
def _taus(results, cfg):
    from basicrta_tpu.postprocess.tau import (AllNoiseError,
                                              estimate_params, estimate_tau)
    taus = {}
    for name, res in results.items():
        try:
            taus[name] = np.asarray(estimate_tau(
                res, cfg.noise_cutoff, estimate_params(res)[0]), float)
        except AllNoiseError:
            taus[name] = np.zeros(3)
    return taus


def phase_post(rec, residues, samples, cfg, n_cpu=None):
    """process_residues_batched on the default device vs the CPU backend.

    Tolerance: tau, lo and hi within 1e-3 relative. Both backends run the
    same f32 programs; their reductions sum in different orders, so a GMM
    label or a sampled vote can flip where two clusters touch, which
    moves tau by up to a histogram bin. Such residues are listed; the
    phase fails when more than 5% of them differ."""
    rtol, max_outside = 1e-3, 0.05
    import jax
    from basicrta_tpu.postprocess.batched import process_residues_batched
    from basicrta_tpu.sampler.kernels import dedup_times

    names = sorted(samples, key=lambda n: int(n[1:]))
    items = {}
    for name in names:
        W, R = samples[name]
        v, c = dedup_times(residues[name])
        items[name] = (W, R, v, c)
    t0 = time.time()
    dev = _taus(process_residues_batched(items, cfg), cfg)
    log(f"  {len(items)} residues on {jax.devices()[0].platform}: "
        f"{time.time() - t0:.2f} s")
    cpu_names = names if n_cpu is None else names[:n_cpu]
    if len(cpu_names) < len(names):
        log(f"  CPU reference cut to the first {len(cpu_names)} of "
            f"{len(names)} residues (CPU time)")
    t0 = time.time()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _taus(process_residues_batched(
            {n: items[n] for n in cpu_names}, cfg), cfg)
    log(f"  {len(cpu_names)} residues on cpu: {time.time() - t0:.2f} s")
    outside = []
    for n in cpu_names:
        a, b = dev[n], cpu[n]
        if not np.allclose(a, b, rtol=rtol, atol=1e-9):
            outside.append(n)
            log(f"  outside tolerance {n}: (lo, tau, hi) device {a} "
                f"cpu {b}")
    log(f"  tau within rtol {rtol}: {len(cpu_names) - len(outside)}/"
        f"{len(cpu_names)}")
    rec["ok"] = len(outside) <= max_outside * len(cpu_names)


# --------------------------------------------------------------- contacts
def compare_rows(rec, rows, cutoff, tol=1e-4, label=""):
    """Device ContactRecords vs cpu_contacts rows: identical (frame,
    residue, ligand) sets except pairs within ``tol`` of the cutoff (each
    listed), minimum distances within ``tol`` A."""
    dev = {(int(f), int(a), int(b)): float(d) for f, a, b, d in zip(
        rec.frames, np.asarray(rec.sel1_resids), np.asarray(rec.sel2_resids),
        np.asarray(rec.min_dist))}
    cpu = {(int(f), int(a), int(b)): float(d) for f, a, b, d in zip(
        rows["frames"], rows["s1"], rows["s2"], rows["dist"])}
    ok = True
    for key in sorted(set(dev) ^ set(cpu)):
        d = dev.get(key, cpu.get(key))
        side = "device only" if key in dev else "cpu only"
        near = abs(d - cutoff) <= tol
        log(f"  {label} pair {key} ({side}) flips at the cutoff: d = {d:.6f}"
            + ("" if near else "  NOT within tolerance of the cutoff"))
        ok = ok and near
    common = set(dev) & set(cpu)
    dmax = max((abs(dev[k] - cpu[k]) for k in common), default=0.0)
    log(f"  {label} {len(dev)} device rows, {len(cpu)} cpu rows, "
        f"{len(common)} common, max |d_dev - d_cpu| = {dmax:.2e} A "
        f"(limit {tol:g})")
    return ok and dmax <= tol and len(common) > 0


def triclinic_batch(n_frames=16):
    """Membrane-scale batch in a GROMACS-reduced triclinic box."""
    import bench
    batches, r1, r2, A1 = bench.make_membrane_frames(n_frames=n_frames,
                                                     batch=n_frames)
    H = np.array([[120.0, 0.0, 0.0], [30.0, 120.0, 0.0],
                  [20.0, -25.0, 90.0]], np.float32)
    b = batches[0]
    b.box = np.tile(H, (len(b.frame_ids), 1, 1))
    return b, r1, r2, A1


def phase_contacts(rec, workdir, n_frames=48, n_tric=16):
    import bench
    from cpu_contacts_baseline import cpu_contacts
    from basicrta_tpu.config import ContactConfig
    from basicrta_tpu.contacts.mapper import FrameBatch, MapContacts
    from basicrta_tpu.contacts.quantize import quantize_u16
    from basicrta_tpu.contacts.records import ContactMeta

    path = bench._bilayer_xtc_path(n_frames, workdir)
    _, r1, r2, A1 = bench.make_membrane_frames_large(n_frames=1)
    A2 = len(r2)
    frames = list(bench._file_batches(path))
    log(f"  bilayer XTC: {A1 + A2} atoms x {n_frames} frames")
    ok = True
    for upload in ("f32", "u16"):
        mc = MapContacts(indices1=np.arange(A1), resids1=r1,
                         indices2=np.arange(A1, A1 + A2), resids2=r2,
                         cfg=ContactConfig(upload_dtype=upload),
                         meta=ContactMeta(ts=0.1))
        mc.run(bench._file_batches(path))                        # cold
        t0 = time.time()
        records = mc.run(bench._file_batches(path))
        fps = n_frames / (time.time() - t0)
        rec[f"contacts_frames_per_s_{upload}"] = fps
        log(f"  TIMING contacts frames/s ({upload}, from the XTC file): "
            f"{fps:.2f}")
        ref_batches = frames
        if upload == "u16":
            # the reference sees the coordinates the device sees: the
            # same quantization, dequantized as the device does
            ref_batches = []
            for b in frames:
                q, scale = quantize_u16(np.asarray(b.positions))
                pos = (q.astype(np.float32) * scale[:, :1, :]
                       + scale[:, 1:, :])
                ref_batches.append(FrameBatch(b.frame_ids, b.times, pos,
                                              box=b.box))
        rows = cpu_contacts(ref_batches, r1, r2, A1)
        ok = compare_rows(records, rows, 10.0, label=upload) and ok

    b, t1, t2, tA1 = triclinic_batch(n_tric)
    tA2 = len(t2)
    mc = MapContacts(indices1=np.arange(tA1), resids1=t1,
                     indices2=np.arange(tA1, tA1 + tA2), resids2=t2,
                     cfg=ContactConfig(upload_dtype="f32"),
                     meta=ContactMeta(ts=0.1))
    records = mc.run([b])
    rows = cpu_contacts([b], t1, t2, tA1)
    ok = compare_rows(records, rows, 10.0, label="triclinic") and ok
    rec["ok"] = ok


# -------------------------------------------------------------------- CLI
class _DensityRecorder:
    """Records every GridAccumulator.add call of the kinetics stage, so
    the written grids can be rebuilt with numpy."""

    def __init__(self):
        from basicrta_tpu.kinetics.density import GridAccumulator
        self.cls = GridAccumulator
        self.orig = GridAccumulator.add
        self.calls = []

    def __enter__(self):
        rec = self

        def add(acc, positions, weights, mask=None, frame_chunk=256):
            rec.calls.append((acc, np.asarray(positions, np.float32),
                              np.asarray(weights, np.float32),
                              None if mask is None
                              else np.asarray(mask, np.float32)))
            return rec.orig(acc, positions, weights, mask, frame_chunk)

        self.cls.add = add
        return self

    def __exit__(self, *exc):
        self.cls.add = self.orig


def check_density(calls, rtol=1e-4):
    """Each accumulator's grid vs np.histogramdd of the same weighted
    positions. The device scatter-adds with atomics (any order), so grids
    agree to f32 reordering: rtol 1e-4 of the grid maximum. Atoms within
    f32 rounding of a bin edge can land in the neighbouring voxel; those
    voxels are counted and left out of the comparison."""
    accs = {}
    for acc, pos, w, mask in calls:
        accs.setdefault(id(acc), [acc, []])[1].append((pos, w, mask))
    ok = True
    for acc, adds in accs.values():
        ref = np.zeros(acc.grids.shape, np.float64)
        skip = np.zeros(acc.grids.shape[1:], bool)
        gmin = np.asarray(acc._gmin)
        delta = np.asarray(acc._delta)
        for pos, w, mask in adds:
            if w.ndim == 1:
                w = w[:, None]
            m = np.ones(pos.shape[:2], np.float32) if mask is None else mask
            flat = pos.reshape(-1, 3)
            for k in range(w.shape[1]):
                wk = (w[:, k][:, None] * m).reshape(-1)
                ref[k] += np.histogramdd(flat, bins=acc.edges,
                                         weights=wk)[0]
            dev_idx = np.floor((flat - gmin) / delta).astype(np.int64)
            np_idx = np.stack([np.searchsorted(acc.edges[d], flat[:, d],
                                               side="right") - 1
                               for d in range(3)], 1)
            for idx in np.unique(np.concatenate(
                    [dev_idx[np.any(dev_idx != np_idx, 1)],
                     np_idx[np.any(dev_idx != np_idx, 1)]]), axis=0):
                if np.all((idx >= 0) & (idx < skip.shape)):
                    skip[tuple(idx)] = True
        atol = rtol * max(float(ref.max()), 1e-12)
        diff = np.abs(acc.grids - ref)
        bad = (diff > atol + rtol * np.abs(ref)) & ~skip[None]
        log(f"  density grid {acc.grids.shape}: max |device - histogramdd|"
            f" = {diff.max():.3g} (tolerance {atol:.3g}), "
            f"{int(skip.sum())} edge voxels skipped, {int(bad.sum())} "
            f"voxels outside")
        ok = ok and not bad.any() and ref.sum() > 0
    return ok and bool(accs)


def phase_cli(rec, workdir, frames=5000, nprot=120, nlip=60,
              niter=110_000, min_cover=0.9):
    """The four CLI stages in process on the planted-kinetics system."""
    from e2e_demo import make_system
    from basicrta_tpu.cli import main as cli
    from basicrta_tpu.sampler.gibbs import Gibbs

    rng = np.random.default_rng(7)
    make_system(workdir, nprot, nlip, frames, 0.1, rng)
    log(f"  system: {nprot} residues, {nlip} lipids, {frames} frames")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for argv in (
                ["contacts", "--top", "top.gro", "--traj", "traj.xtc",
                 "--sel1", "protein", "--sel2", "resname CHOL",
                 "--cutoff", "7.0", "--batch", "128"],
                ["gibbs", "--contacts", "contacts_7.0.npz",
                 "--niter", str(niter)],
                ["cluster", "--cutoff", "7.0", "--niter", str(niter),
                 "--structure", "struct.pdb"]):
            t0 = time.time()
            cli(argv)
            log(f"  stage {argv[0]}: {time.time() - t0:.2f} s")
        # residues with bound lipids: lipid l binds residue (l % nprot) + 1
        bound = {(lip % nprot) + 1 for lip in range(nlip)}
        cover = []
        for path in sorted(glob.glob(f"basicrta-7.0/*/gibbs_{niter}.npz")):
            g = Gibbs.load(path)
            resid = int(str(g.residue)[1:])
            if resid in bound and g.tau is not None:
                lo, tau, hi = (float(x) for x in g.tau)
                covers = lo <= SLOW_TAU_NS <= hi
                cover.append(covers)
                if not covers:
                    log(f"  {g.residue}: tau {tau:.3f} ns, CI [{lo:.3f}, "
                        f"{hi:.3f}] misses {SLOW_TAU_NS} ns")
        frac = float(np.mean(cover)) if cover else 0.0
        log(f"  tau CI covers {SLOW_TAU_NS} ns for {sum(cover)}/"
            f"{len(cover)} residues with bound lipids "
            f"(required: {min_cover:.0%})")
        t0 = time.time()
        with _DensityRecorder() as recd:
            cli(["kinetics", "--gibbs", f"basicrta-7.0/W1/gibbs_{niter}.npz",
                 "--contacts", "contacts_7.0.npz", "--wdensity"])
        log(f"  stage kinetics: {time.time() - t0:.2f} s")
        dens_ok = check_density(recd.calls)
        rec["ok"] = frac >= min_cover and dens_ok
    finally:
        os.chdir(cwd)


# ------------------------------------------------------- multi-device
def phase_four(rec, workdir, n_devices=4, n_residues=300, niter=SWEEPS,
               g=G, interpret=False, n_frames=48, n_sigma=4.0):
    """Each multi-device path against its one-device counterpart."""
    import jax
    import bench
    from basicrta_tpu.config import GibbsConfig
    from basicrta_tpu.config import ContactConfig
    from basicrta_tpu.contacts.mapper import MapContacts
    from basicrta_tpu.contacts.records import ContactMeta
    from basicrta_tpu.kinetics.density import GridAccumulator
    from basicrta_tpu.parallel.mesh import lane_sharding, make_mesh
    from basicrta_tpu.sampler.batch import (bucket_residues, resolve_engine,
                                            run_batch, run_residues)
    from jax.sharding import NamedSharding, PartitionSpec as P

    devs = jax.devices()[:n_devices]
    engine = resolve_engine("pallas" if interpret else "auto", interpret)
    residues = bench.make_workload(n_residues)
    cfg = GibbsConfig(ncomp=NCOMP, niter=niter, g=g,
                      burnin=max(g, niter // 10), n_chains=2)
    ok = True

    # lane-sharded sampling (gibbs --ndevices 4): lane streams are keyed
    # by global lane index, so the sharded chains equal the one-card ones
    sh = lane_sharding(make_mesh(n_lanes=n_devices, devices=devs))
    t0 = time.time()
    a = run_residues(residues, cfg, n_chains=2, engine=engine,
                     interpret=interpret, sharding=sh)
    log(f"  lane-sharded {engine} over {n_devices} devices: "
        f"{time.time() - t0:.2f} s")
    b = run_residues(residues, cfg, n_chains=2, engine=engine,
                     interpret=interpret)
    dmax = max(float(np.abs(a[n][k] - b[n][k]).max())
               for n in a for k in (0, 1))
    log(f"  lane-sharded vs one device: max |diff| over all chains = "
        f"{dmax:.3g} (limit 1e-5)")
    ok = ok and dmax <= 1e-5

    # the flagship lane event-sharded (XLA engine, psum of (N_k, T_k)
    # each sweep) vs the same lane on one device, in law
    mesh = make_mesh(n_lanes=1, n_events=n_devices, devices=devs)
    fl = {f"R0#{c}": residues["R0"] for c in range(2)}
    batch = bucket_residues(fl)[0]
    t0 = time.time()
    ev = run_batch(batch, cfg, engine="xla",
                   sharding=NamedSharding(mesh, P("lanes", "events")))
    log(f"  flagship event-sharded over {n_devices} devices: "
        f"{time.time() - t0:.2f} s")
    one = run_residues({"R0": residues["R0"]}, cfg, n_chains=2,
                       engine=engine, interpret=interpret)["R0"]
    law = law_check("event-sharded flagship", ev.mcweights, ev.mcrates,
                    *one, residues["R0"], cfg.burnin_samples, n_sigma)
    log(f"  event-sharded flagship vs one device in law: {law}")
    ok = ok and law

    # frame-sharded contacts: rows identical to one device's
    path = bench._bilayer_xtc_path(n_frames, workdir)
    _, r1, r2, A1 = bench.make_membrane_frames_large(n_frames=1)
    A2 = len(r2)
    kw = dict(indices1=np.arange(A1), resids1=r1,
              indices2=np.arange(A1, A1 + A2), resids2=r2,
              cfg=ContactConfig(upload_dtype="f32"),
              meta=ContactMeta(ts=0.1))
    rec_sh = MapContacts(n_devices=n_devices, **kw).run(
        bench._file_batches(path))
    rec_one = MapContacts(**kw).run(bench._file_batches(path))
    same = (np.array_equal(rec_sh.frames, rec_one.frames)
            and np.array_equal(rec_sh.sel1_resids, rec_one.sel1_resids)
            and np.array_equal(rec_sh.sel2_resids, rec_one.sel2_resids)
            and np.array_equal(rec_sh.min_dist, rec_one.min_dist))
    log(f"  frame-sharded contacts: {len(rec_sh)} rows, identical to one "
        f"device: {same}")
    ok = ok and same

    # frame-sharded density vs the unsharded grid (atomics: rtol 1e-4 of
    # the grid maximum)
    rng = np.random.default_rng(5)
    K, F, A = 3, 4 * n_devices + 3, 500      # odd F exercises padding
    pos = rng.uniform(0, 40, (F, A, 3)).astype(np.float32)
    w = rng.random((F, K)).astype(np.float32)
    mask = (rng.random((F, A)) < 0.9).astype(np.float32)
    acc_one = GridAccumulator(K, gridcenter=[20.0, 20.0, 20.0])
    acc_one.add(pos, w, mask=mask)
    acc_sh = GridAccumulator(K, gridcenter=[20.0, 20.0, 20.0],
                             mesh=make_mesh(n_lanes=n_devices, devices=devs))
    acc_sh.add(pos, w, mask=mask)
    diff = float(np.abs(acc_sh.grids - acc_one.grids).max())
    tol = 1e-4 * float(acc_one.grids.max())
    log(f"  frame-sharded density: max |diff| = {diff:.3g} "
        f"(tolerance {tol:.3g})")
    rec["ok"] = bool(ok and diff <= tol and acc_one.grids.sum() > 0)


# ------------------------------------------------------------------ main
def main(argv=None):
    global _COMPILES
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args(argv)

    enable_compilation_cache()
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX devices: {devices}); "
              "this smoke test runs only on the card", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    _COMPILES = _Compiles()
    log(f"devices: {devices}")
    log(f"card (name, power limit): {card_info()}")

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            with phase("four", results) as rec:
                phase_four(rec, tmp)
        else:
            state = {}
            with phase("sampler", results) as rec:
                state["run"] = phase_sampler(rec)
            with phase("post", results) as rec:
                residues, samples, cfg = state["run"]
                phase_post(rec, residues, samples, cfg, n_cpu=64)
            with phase("contacts", results) as rec:
                phase_contacts(rec, tmp)
            cli_dir = os.path.join(tmp, "cli")
            os.makedirs(cli_dir)
            with phase("cli", results) as rec:
                phase_cli(rec, cli_dir)

    log("summary: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "error"}
         for k, v in results.items()}, default=float))
    if not all(r["ok"] for r in results.values()):
        log("FAILED phases: " + ", ".join(
            k for k, r in results.items() if not r["ok"]))
        return 1
    d = devices[0]
    print(json.dumps({"ok": True,
                      "device": {"platform": d.platform,
                                 "kind": d.device_kind,
                                 "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
