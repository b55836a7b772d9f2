"""Headline benchmark: aggregated Gibbs sweeps/sec/chip on an all-residue run.

Workload: a full-protein-scale batch — 300 residues whose event counts span
1e2 .. 4.5e5 (one flagship residue matches the bundled W313 dataset's scale:
446,605 events) with K=15 mixture components, the reference's canonical
configuration (reference gibbs.py:133, BASELINE.md). Data is synthetic but
matched to the real dataset's computational shape (unique-value count and
multiplicity skew; W313 has V=870 unique times for 446k events).

Baseline: 2.11 sweeps/s measured for the reference's inner loop
(gibbs.py:196-211) on one CPU core on the flagship residue (BASELINE.md).
``vs_baseline`` is aggregate device sweeps/s divided by that number.

Runs only on a GPU (a measurement that finds no card fails instead of
timing the CPU). Prints ONE JSON line to stdout, naming the device and
the card's power limit.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from basicrta_tpu.jax_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from basicrta_tpu.config import GibbsConfig  # noqa: E402
from basicrta_tpu.ops.surv import (discretize_times,  # noqa: E402
                                   simulate_hyperexp)
from basicrta_tpu.sampler.batch import (bucket_residues,  # noqa: E402
                                        finalize_batch, run_batch)

BASELINE_SWEEPS_PER_SEC = 2.11  # reference inner loop, 1 CPU core (BASELINE.md)
# reference-semantics contacts baseline: cKDTree periodic capped-distance
# search + vectorized per-residue-pair min reduction, 1 CPU core, measured
# by scripts/cpu_contacts_baseline.py on these exact workloads (BASELINE.md)
BASELINE_CONTACTS_FPS = 26.1        # membrane workload (14,800 atoms)
BASELINE_CONTACTS_LARGE_FPS = 7.57  # bilayer workload (101,400 atoms)
# overridable for smoke runs (e.g. BENCH_RESIDUES=8 BENCH_SWEEPS=200)
N_RESIDUES = int(os.environ.get("BENCH_RESIDUES", "300"))
# one full production segment (segment_blocks=100 x g=100): short enough to
# keep the bench fast, long enough that per-bucket dispatch/upload/sync
# overheads amortize as they do in a real 110k-sweep run
TIMED_SWEEPS = int(os.environ.get("BENCH_SWEEPS", "10000"))


def make_workload(n_residues=N_RESIDUES, seed=0):
    """Synthetic all-residue workload matched to the W313 dataset shape."""
    rng = np.random.default_rng(seed)
    # W313-posterior-like mixture: concentrated, V ~ 900 at N ~ 4.5e5
    w = np.array([0.87, 0.09, 0.03, 0.009, 0.001])
    r = np.array([4.7, 1.3, 0.33, 0.06, 0.009])
    residues = {}
    sizes = np.concatenate([
        [446605],  # flagship residue at the bundled dataset's size
        (10 ** rng.uniform(2.0, 5.3, n_residues - 1)).astype(int)])
    for i, n in enumerate(sizes):
        scale = rng.uniform(0.7, 1.5)
        residues[f"R{i}"] = discretize_times(
            simulate_hyperexp(int(n), w, r * scale, rng), 0.1)
    return residues


def make_membrane_frames(n_frames=96, batch=16, seed=7):
    """Membrane-scale synthetic contact workload: 300 protein residues x
    16 atoms against 200 lipids x 50 atoms (14,800 atoms in the two
    selections) in a 120x120x90 A box,
    residues as compact clusters so bounding-sphere pruning reflects a
    real bilayer's contact sparsity."""
    from basicrta_tpu.contacts.mapper import FrameBatch

    rng = np.random.default_rng(seed)
    R1, P1, R2, P2 = 300, 16, 200, 50
    box_l = np.array([120.0, 120.0, 90.0], np.float32)
    c1 = rng.uniform(0, 1, (R1, 3)) * box_l
    c2 = rng.uniform(0, 1, (R2, 3)) * box_l
    resids1 = np.repeat(np.arange(R1), P1)
    resids2 = np.repeat(np.arange(R2) + 1000, P2)
    batches = []
    for lo in range(0, n_frames, batch):
        F = min(batch, n_frames - lo)
        drift1 = c1[None] + rng.normal(0, 0.4, (F, R1, 3))
        drift2 = c2[None] + rng.normal(0, 0.4, (F, R2, 3))
        p1 = (drift1[:, :, None] + rng.normal(0, 2.0, (F, R1, P1, 3)))
        p2 = (drift2[:, :, None] + rng.normal(0, 2.5, (F, R2, P2, 3)))
        pos = np.concatenate([p1.reshape(F, -1, 3), p2.reshape(F, -1, 3)],
                             axis=1).astype(np.float32)
        batches.append(FrameBatch(
            np.arange(lo, lo + F), np.arange(lo, lo + F) * 0.1, pos,
            box=np.tile(box_l, (F, 1))))
    return batches, resids1, resids2, R1 * P1


def make_membrane_frames_large(n_frames=48, batch=16, seed=11):
    """Bilayer-scale synthetic contact workload: 400 protein residues x
    16 atoms against 1,900 lipids x 50 atoms — 101,400 atoms in the two
    selections (a >=100k-atom datapoint) in a
    240x240x155 A box at the same ~88 A^3/atom density as the membrane
    workload. 608M atom pairs/frame puts it past
    ``prefilter_auto_pairs``, so this exercises the bounding-sphere
    pruned path the 14.8k-atom workload never reaches."""
    from basicrta_tpu.contacts.mapper import FrameBatch

    rng = np.random.default_rng(seed)
    R1, P1, R2, P2 = 400, 16, 1900, 50
    box_l = np.array([240.0, 240.0, 155.0], np.float32)
    c1 = rng.uniform(0, 1, (R1, 3)) * box_l
    c2 = rng.uniform(0, 1, (R2, 3)) * box_l
    resids1 = np.repeat(np.arange(R1), P1)
    resids2 = np.repeat(np.arange(R2) + 10000, P2)
    batches = []
    for lo in range(0, n_frames, batch):
        F = min(batch, n_frames - lo)
        drift1 = c1[None] + rng.normal(0, 0.4, (F, R1, 3))
        drift2 = c2[None] + rng.normal(0, 0.4, (F, R2, 3))
        p1 = (drift1[:, :, None] + rng.normal(0, 2.0, (F, R1, P1, 3)))
        p2 = (drift2[:, :, None] + rng.normal(0, 2.5, (F, R2, P2, 3)))
        pos = np.concatenate([p1.reshape(F, -1, 3), p2.reshape(F, -1, 3)],
                             axis=1).astype(np.float32)
        batches.append(FrameBatch(
            np.arange(lo, lo + F), np.arange(lo, lo + F) * 0.1, pos,
            box=np.tile(box_l, (F, 1))))
    return batches, resids1, resids2, R1 * P1


def bench_contacts(large=False, upload="f32"):
    """Frames/s through MapContacts (prefilter auto: dense at membrane
    scale, bounding-sphere pruned at the 101k-atom bilayer scale).
    ``upload='u16'`` measures the quantized wire format an XTC user gets
    (CLI --upload auto; halves the host->device bytes)."""
    from basicrta_tpu.config import ContactConfig
    from basicrta_tpu.contacts.mapper import MapContacts
    from basicrta_tpu.contacts.records import ContactMeta

    batches, resids1, resids2, A1 = (make_membrane_frames_large()
                                     if large else make_membrane_frames())
    n_frames = sum(len(b.frame_ids) for b in batches)
    A2 = len(resids2)
    mc = MapContacts(indices1=np.arange(A1), resids1=resids1,
                     indices2=np.arange(A1, A1 + A2), resids2=resids2,
                     cfg=ContactConfig(upload_dtype=upload),
                     meta=ContactMeta(ts=0.1))
    rec = mc.run(batches)             # cold (compiles)
    t0 = time.time()
    rec = mc.run(batches)             # warm
    elapsed = time.time() - t0
    return n_frames / elapsed, len(rec.frames), n_frames


def _bilayer_xtc_path(n_frames, directory):
    """Write (once per directory) the bilayer workload as a real XTC file:
    the decode-inclusive stage-1 measurement the reference pays inline
    (reference contacts.py:100-132 iterates the trajectory reader in the
    hot loop). 101,400 atoms x n_frames through the native C codec."""
    from basicrta_tpu.io.native import XTCWriter
    path = os.path.join(directory, f"bench_bilayer_{n_frames}.xtc")
    if os.path.exists(path):
        return path
    batches, _, _, _ = make_membrane_frames_large(n_frames=n_frames)
    tmp = path + ".tmp"
    w = XTCWriter(tmp)                # subsequent write() calls append
    for b in batches:
        w.write(np.asarray(b.positions, np.float32),
                np.asarray(b.times, np.float64),
                np.asarray(b.box, np.float32),
                steps=np.asarray(b.frame_ids, np.int32))
    os.replace(tmp, path)
    return path


def _file_batches(path, batch=16):
    """FrameBatch generator decoding an XTC chunk-by-chunk — the exact
    shape MapContacts.run consumes from Universe.iter_batches, so decode
    lands on the pipeline's main thread and overlaps device compute."""
    from basicrta_tpu.contacts.mapper import FrameBatch
    from basicrta_tpu.io.native import XTCReader

    rd = XTCReader(path)
    for lo in range(0, rd.nframes, batch):
        idx = np.arange(lo, min(lo + batch, rd.nframes))
        coords, times, box, _ = rd.read(idx)
        yield FrameBatch(idx, times,
                         coords, box=np.stack([np.diag(b) for b in box]))


def bench_contacts_e2e_file(directory, n_frames=48, upload="u16"):
    """End-to-end frames/s from a real trajectory FILE at bilayer scale:
    XTC decode + host layout/quantize + upload + device kernel + transfer
    + host assembly, nothing composed from parts. Returns (fps,
    decode_s_per_frame, rows).

    ``upload='u16'`` is what the CLI auto-selects for XTC input (the
    file's native storage grid is 0.01 A, so quantization adds nothing).
    """
    from basicrta_tpu.config import ContactConfig
    from basicrta_tpu.contacts.mapper import MapContacts
    from basicrta_tpu.contacts.records import ContactMeta

    path = _bilayer_xtc_path(n_frames, directory)
    _, resids1, resids2, A1 = make_membrane_frames_large(n_frames=16)
    A2 = len(resids2)
    mc = MapContacts(indices1=np.arange(A1), resids1=resids1,
                     indices2=np.arange(A1, A1 + A2), resids2=resids2,
                     cfg=ContactConfig(upload_dtype=upload),
                     meta=ContactMeta(ts=0.1))
    # decode share: a dedicated pass through the reader alone
    t0 = time.time()
    for b in _file_batches(path):
        pass
    decode_s = (time.time() - t0) / n_frames
    mc.run(_file_batches(path))                  # cold (compiles)
    t0 = time.time()
    rec = mc.run(_file_batches(path))            # warm
    fps = n_frames / (time.time() - t0)
    return fps, decode_s, len(rec.frames)


def bench_contacts_e2e_file_cpu(directory, n_frames=8):
    """File-driven CPU baseline: same XTC, native decode + the
    reference-semantics cKDTree contact search inline per frame (the
    shape of the reference's single-core stage 1). Few frames — the
    point is a per-frame rate."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from cpu_contacts_baseline import cpu_contacts
    _, resids1, resids2, A1 = make_membrane_frames_large(n_frames=16)
    path = _bilayer_xtc_path(48, directory)
    t0 = time.time()
    done = 0
    for b in _file_batches(path, batch=4):
        take = min(len(b.frame_ids), n_frames - done)
        b.positions = b.positions[:take]
        b.frame_ids, b.times = b.frame_ids[:take], b.times[:take]
        b.box = b.box[:take]
        cpu_contacts([b], resids1, resids2, A1)
        done += take
        if done >= n_frames:
            break
    return done / (time.time() - t0)


def bench_contacts_breakdown(reps=3, large=False, upload="f32"):
    """Attribute the contacts wall-clock: the production device pass (MapContacts._device_pass — dense+compact at
    membrane scale, bounding-sphere pruned at bilayer scale) decomposed
    into host layout/quantize, host->device upload, device kernel compute,
    device->host link transfer of the fused buffer, and host row assembly
    — measured sequentially (no pipeline) so each phase syncs alone.
    Compare the phase sum against the pipelined bench_contacts number for
    overlap efficiency."""
    import jax
    import jax.numpy as jnp
    from basicrta_tpu.config import ContactConfig
    from basicrta_tpu.contacts.mapper import MapContacts
    from basicrta_tpu.contacts.records import ContactMeta

    cfg = ContactConfig(upload_dtype=upload)
    batches, resids1, resids2, A1 = (make_membrane_frames_large()
                                     if large else make_membrane_frames())
    n_frames = sum(len(b.frame_ids) for b in batches)
    A2 = len(resids2)
    mc = MapContacts(indices1=np.arange(A1), resids1=resids1,
                     indices2=np.arange(A1, A1 + A2), resids2=resids2,
                     cfg=cfg, meta=ContactMeta(ts=0.1))
    R1, R2 = len(mc.uniq_resids1), len(mc.uniq_resids2)
    prefilter = mc._prefilter_active()
    cap = int(cfg.prefilter_cap if prefilter else cfg.transfer_cap)
    mode = "pruned" if prefilter else "dense"
    if prefilter:
        # size the cap as the adaptive production loop would: the exact
        # fit's pow2 with the 1.25x margin
        rec = mc.run(batches)    # also warms the compile cache
        peak = 0
        for b in batches:
            pos, box, scale, use_pbc, tric, q = _bd_prepare(b, cfg)
            out = mc._jit_pass(pos, box, scale, mode="pruned",
                               cap=int(cfg.prefilter_cap), use_pbc=use_pbc,
                               triclinic=tric, quantized=q)
            n_pl = np.asarray(out)[:, 0].astype(np.int64)
            peak = max(peak, int(n_pl.max()))
        cap = 1 << (max((5 * peak) // 4, 16) - 1).bit_length()

    sync = jax.block_until_ready

    def run_pass(pos, box, scale, use_pbc, tric, q):
        out = mc._jit_pass(pos, box, scale, mode=mode, cap=cap,
                           use_pbc=use_pbc, triclinic=tric, quantized=q)
        return out[1] if mode == "dense" else out

    # warm everything once
    for b in batches:
        sync(run_pass(*_bd_prepare(b, cfg)))

    t_prep = t_up = t_dev = t_xfer = t_host = float("inf")
    for _ in range(reps):
        prep_s = up = dev = xfer = host = 0.0
        outs = []
        for b in batches:
            t0 = time.time()
            hostargs = _bd_prepare(b, cfg, host_only=True)
            prep_s += time.time() - t0
            t0 = time.time()
            pos = jnp.asarray(hostargs[0])
            box = (jnp.asarray(hostargs[1]) if hostargs[1] is not None
                   else None)
            scale = (jnp.asarray(hostargs[2]) if hostargs[2] is not None
                     else None)
            sync(pos)
            up += time.time() - t0
            t0 = time.time()
            out = run_pass(pos, box, scale, *hostargs[3:])
            sync(out)
            dev += time.time() - t0
            t0 = time.time()
            arr = np.asarray(out)
            xfer += time.time() - t0
            outs.append((arr, b))
        t0 = time.time()
        for arr, b in outs:
            c = (arr.shape[1] - 1) // 2
            cidx = arr[:, 1:1 + c].astype(np.int64)
            cd = arr[:, 1 + c:]
            fk, kk = np.nonzero(cd <= cfg.map_cutoff)
            flat = cidx[fk, kk]
            order = np.lexsort((flat, fk))
            fk, flat = fk[order], flat[order]
            _ = (np.asarray(b.frame_ids)[fk], mc.uniq_resids1[flat // R2],
                 mc.uniq_resids2[flat % R2], cd[fk, kk[order]],
                 np.asarray(b.times)[fk])
        host += time.time() - t0
        t_prep, t_up = min(t_prep, prep_s), min(t_up, up)
        t_dev = min(t_dev, dev)
        t_xfer, t_host = min(t_xfer, xfer), min(t_host, host)
    return {"prep_s_per_frame": t_prep / n_frames,
            "upload_s_per_frame": t_up / n_frames,
            "device_s_per_frame": t_dev / n_frames,
            "transfer_s_per_frame": t_xfer / n_frames,
            "host_s_per_frame": t_host / n_frames}


def _bd_prepare(b, cfg, host_only=False):
    """Host-side batch prep mirroring MapContacts.run's prepare (identity
    layout — the bench workloads' atoms are already residue-ordered)."""
    import jax.numpy as jnp
    positions = np.asarray(b.positions)
    boxarr = np.asarray(b.box)
    quantized = cfg.upload_dtype == "u16"
    scale = None
    if quantized:
        # the exact production quantizer (shared helper; wrap-safety
        # bound lives with it in contacts/quantize.py)
        from basicrta_tpu.contacts.quantize import quantize_u16
        positions, scale = quantize_u16(positions)
    else:
        positions = positions.astype(np.float32)
    boxarr = boxarr.astype(np.float32)
    if host_only:
        return positions, boxarr, scale, True, False, quantized
    return (jnp.asarray(positions), jnp.asarray(boxarr),
            None if scale is None else jnp.asarray(scale),
            True, False, quantized)


def _timed_agg(residues, cfg, engine):
    """Aggregate sweeps/s for one engine (after its own warmup pass).
    Buckets dispatch with deferred transfers: bucket i+1 computes while
    bucket i streams back."""
    batches = bucket_residues(residues)
    for b in batches:
        run_batch(b, cfg, engine=engine)
    t0 = time.time()
    outs = [run_batch(b, cfg, engine=engine, defer_transfer=True)
            for b in batches]
    for o in outs:
        finalize_batch(o)
    elapsed = time.time() - t0
    return sum(b.size for b in batches) * cfg.niter / elapsed


def main():
    import tempfile

    import jax
    from chip_smoke import card_info
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found ({jax.devices()}); the benchmark "
                 "measures the card only")
    residues = make_workload()
    cfg = GibbsConfig(ncomp=15, niter=TIMED_SWEEPS, g=100)
    engine = "pallas"
    agg = _timed_agg(residues, cfg, engine)
    extras = {"engine": engine,
              "device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "card": card_info(),
              "buckets": [list(b.values.shape) for b in
                          bucket_residues(residues)]}
    # the XLA engine is launch-bound (constant cost per sweep), so a
    # tenth of the segment measures its rate
    xcfg = GibbsConfig(ncomp=15, niter=TIMED_SWEEPS // 10, g=100)
    extras["xla_sweeps_per_sec"] = round(_timed_agg(residues, xcfg, "xla"),
                                         1)

    # flagship single-residue throughput (the W313-size lane alone)
    fcfg = GibbsConfig(ncomp=15, niter=10 * TIMED_SWEEPS, g=100)
    extras["flagship_sweeps_per_sec"] = round(
        _timed_agg({"R0": residues["R0"]}, fcfg, engine), 1)

    # the CLI default is --nchains 2: the same 300 residues with every
    # residue doubled into two chain lanes, as run_residues expands it.
    # agg_sweeps_2chain counts LANE-sweeps (600 lanes); two_chain_cost is
    # the wall-clock overhead vs the single-chain headline.
    expanded = {f"{name}#{c}": t for name, t in residues.items()
                for c in range(2)}
    agg2 = _timed_agg(expanded, cfg, engine)
    extras["agg_sweeps_2chain"] = round(agg2, 1)
    extras["two_chain_cost"] = round(2.0 * agg / agg2 - 1.0, 3)

    # batched post-processing; warm pass = steady state once bucket
    # programs are compiled
    from basicrta_tpu.postprocess.batched import process_residues_batched
    pcfg = GibbsConfig(ncomp=15, niter=TIMED_SWEEPS, g=100,
                       burnin=TIMED_SWEEPS // 10)
    sub_names = set(list(residues)[:64])
    items = {}
    for b in bucket_residues(residues):
        picked = [i for i, n in enumerate(b.names) if n in sub_names]
        if not picked:
            continue
        res = run_batch(b, cfg, engine=engine)
        for i in picked:
            live = b.counts[i] > 0
            items[b.names[i]] = (res.mcweights[i][None],
                                 res.mcrates[i][None],
                                 b.values[i][live], b.counts[i][live])
    process_residues_batched(items, pcfg)       # cold (compiles)
    t0 = time.time()
    process_residues_batched(items, pcfg)       # warm
    extras["post_warm_s_per_residue"] = round(
        (time.time() - t0) / len(items), 4)

    # contacts: membrane scale, and the 101k-atom bilayer in both wire
    # formats (f32 exact; u16 what the CLI picks for XTC inputs)
    fps, n_rows, _ = bench_contacts()
    extras["contacts_frames_per_sec"] = round(fps, 1)
    extras["contacts_rows"] = int(n_rows)
    extras["contacts_vs_baseline"] = round(fps / BASELINE_CONTACTS_FPS, 2)
    fps_l, _, _ = bench_contacts(large=True)
    extras["contacts_large_frames_per_sec"] = round(fps_l, 1)
    extras["contacts_large_atoms"] = 101_400
    extras["contacts_large_vs_baseline"] = round(
        fps_l / BASELINE_CONTACTS_LARGE_FPS, 2)
    fps_lq, _, _ = bench_contacts(large=True, upload="u16")
    extras["contacts_large_u16_frames_per_sec"] = round(fps_lq, 1)

    # decode-inclusive contacts from a real XTC file at bilayer scale,
    # and the same file through native decode + the cKDTree
    # reference-semantics search (the reference's single-core stage 1)
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        fps_e2e, dec_s, rows_e2e = bench_contacts_e2e_file(tmp)
        extras["contacts_e2e_file_fps"] = round(fps_e2e, 1)
        extras["contacts_e2e_decode_s_per_frame"] = round(dec_s, 5)
        extras["contacts_e2e_rows"] = int(rows_e2e)
        cpu_fps = bench_contacts_e2e_file_cpu(tmp)
        extras["contacts_e2e_file_cpu_fps"] = round(cpu_fps, 2)

    # wall-clock attribution of the contacts stage: host prep / upload /
    # device / transfer / host assembly, and the pipeline's overlap
    bd = bench_contacts_breakdown()
    for k, v in bd.items():
        extras[f"contacts_{k}"] = round(v, 5)
    extras["contacts_overlap_eff"] = round(
        sum(bd.values()) * extras["contacts_frames_per_sec"], 3)

    print(json.dumps({
        "metric": "gibbs_sweeps_per_sec",
        "value": round(agg, 1),
        "unit": f"sweeps/s (aggregate, {N_RESIDUES}-residue batch, K=15, "
                f"{dev.device_kind})",
        "vs_baseline": round(agg / BASELINE_SWEEPS_PER_SEC, 1),
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
