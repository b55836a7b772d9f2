"""Reference-semantics CPU baseline for the contacts stage.

The reference's contact extraction runs, per frame,
``MDAnalysis.lib.distances.capped_distance(ag1.positions, ag2.positions,
max_cutoff=cutoff, box=dims)`` — a C cell-list neighbor search — and then
reduces the returned atom pairs to a per-(sel1 residue, sel2 residue)
minimum distance (reference contacts.py:115-127). MDAnalysis is not
installed in this container, so — exactly like BASELINE.md's numpy replica
of the Gibbs inner loop — this script replicates those semantics with the
strongest generally-available CPU equivalent: a ``scipy.spatial.cKDTree``
periodic capped-distance query (C cell/tree search, the same asymptotics
as capped_distance's pkdtree/nsgrid methods) plus a vectorized
sort/reduceat min-reduction (strictly faster than the reference's
per-frame ``collections.Counter`` Python loop, so the measured number is
a *generous* stand-in for the reference).

Measures frames/s on bench.py's two synthetic workloads:

- membrane: 14,800 atoms (300 res x 16 vs 200 lipids x 50), the workload
  BENCH extras' ``contacts_frames_per_sec`` runs on;
- large: 101,400 atoms (400 res x 16 vs 1,900 lipids x 50), the >=100k
  datapoint (``contacts_large_frames_per_sec``).

Also cross-checks row parity: the CPU rows must match the device mapper's
rows exactly (same (frame, resid1, resid2) set, distances to f32
tolerance) — the baseline and the benchmark must be computing the same
answer for the comparison to mean anything.

Record the measured numbers in BASELINE.md and bench.py's
``BASELINE_CONTACTS_FPS`` / ``BASELINE_CONTACTS_LARGE_FPS`` constants.

Usage:
    python scripts/cpu_contacts_baseline.py [--reps 3] [--parity]
"""

import argparse
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cpu_contacts(batches, resids1, resids2, n_atoms1, cutoff=10.0):
    """Reference-semantics contact rows for a list of FrameBatches.

    Returns column arrays (frames, s1, s2, dist, times) identical in
    schema to ContactRecords (reference shard rows, contacts.py:125-127).
    """
    uniq1, rmap1_all = np.unique(resids1, return_inverse=True)
    uniq2, rmap2_all = np.unique(resids2, return_inverse=True)
    R2 = len(uniq2)
    out = {k: [] for k in ("frames", "s1", "s2", "dist", "times")}
    for b in batches:
        for k in range(len(b.frame_ids)):
            box = np.asarray(b.box[k], np.float64)
            pos = np.asarray(b.positions[k], np.float64)
            if box.ndim == 2:
                d = _triclinic_pairs(pos[:n_atoms1], pos[n_atoms1:], box,
                                     cutoff)
            else:
                p1 = np.mod(pos[:n_atoms1], box)
                p2 = np.mod(pos[n_atoms1:], box)
                # capped periodic neighbor search (reference
                # contacts.py:115-117 semantics: all cross-group atom
                # pairs within max_cutoff under the minimum-image
                # convention)
                t1 = cKDTree(p1, boxsize=box)
                t2 = cKDTree(p2, boxsize=box)
                d = t1.sparse_distance_matrix(t2, cutoff,
                                              output_type="ndarray")
            if not len(d):
                continue
            # min distance per (res1, res2) pair (reference
            # contacts.py:118-127 Counter reduction, vectorized)
            key = rmap1_all[d["i"]].astype(np.int64) * R2 \
                + rmap2_all[d["j"]]
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            v_s = d["v"][order]
            starts = np.flatnonzero(
                np.r_[True, key_s[1:] != key_s[:-1]])
            kk = key_s[starts]
            mins = np.minimum.reduceat(v_s, starts)
            out["frames"].append(
                np.full(len(kk), b.frame_ids[k], np.int64))
            out["s1"].append(uniq1[kk // R2].astype(np.int32))
            out["s2"].append(uniq2[kk % R2].astype(np.int32))
            out["dist"].append(mins.astype(np.float32))
            out["times"].append(
                np.full(len(kk), b.times[k], np.float64))
    return {k: (np.concatenate(v) if v else np.zeros(0))
            for k, v in out.items()}


def _triclinic_pairs(p1, p2, H, cutoff):
    """Minimum-image atom pairs within ``cutoff`` in a triclinic box (rows
    of H are the GROMACS-reduced lattice vectors): both groups wrapped
    into the unit cell, group 2 replicated over the 27 neighbouring
    images, one non-periodic tree query, minimum over images per pair.
    Exact while the cutoff is below half the shortest box height."""
    inv = np.linalg.inv(H)

    def wrap(p):
        f = p @ inv
        return (f - np.floor(f)) @ H

    p1, p2 = wrap(p1), wrap(p2)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64) @ H
    img = (p2[None] + shifts[:, None]).reshape(-1, 3)
    d = cKDTree(p1).sparse_distance_matrix(cKDTree(img), cutoff,
                                           output_type="ndarray")
    j = d["j"] % len(p2)
    key = d["i"].astype(np.int64) * len(p2) + j
    order = np.lexsort((d["v"], key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    sel = order[first]
    out = np.empty(len(sel), dtype=[("i", np.int64), ("j", np.int64),
                                    ("v", np.float64)])
    out["i"], out["j"], out["v"] = d["i"][sel], j[sel], d["v"][sel]
    return out


def _check_parity(rows, rec):
    """CPU rows vs the device mapper's ContactRecords: same pair set,
    distances within f32 kernel tolerance."""
    def keyset(f, s1, s2):
        return set(zip(f.tolist(), s1.tolist(), s2.tolist()))

    cpu_keys = keyset(rows["frames"], rows["s1"], rows["s2"])
    dev_keys = keyset(rec.frames, np.asarray(rec.sel1_resids),
                      np.asarray(rec.sel2_resids))
    assert cpu_keys == dev_keys, (
        f"pair sets differ: cpu-only={len(cpu_keys - dev_keys)}, "
        f"device-only={len(dev_keys - cpu_keys)}")
    cpu_order = np.lexsort((rows["s2"], rows["s1"], rows["frames"]))
    dev_order = np.lexsort((np.asarray(rec.sel2_resids),
                            np.asarray(rec.sel1_resids),
                            np.asarray(rec.frames)))
    dmax = float(np.abs(rows["dist"][cpu_order]
                        - np.asarray(rec.min_dist)[dev_order]).max())
    assert dmax < 2e-3, f"distance mismatch {dmax}"
    print(f"  parity OK: {len(cpu_keys)} rows, max |d_cpu - d_dev| "
          f"= {dmax:.2e} A")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parity", action="store_true",
                    help="also run the device mapper and check row parity "
                         "(needs a reachable device backend)")
    ap.add_argument("--skip-large", action="store_true")
    args = ap.parse_args()

    import bench as B

    workloads = {"membrane": B.make_membrane_frames()}
    if not args.skip_large:
        workloads["large"] = B.make_membrane_frames_large()

    for name, (batches, resids1, resids2, A1) in workloads.items():
        n_frames = sum(len(b.frame_ids) for b in batches)
        n_atoms = batches[0].positions.shape[1]
        rows = cpu_contacts(batches, resids1, resids2, A1)  # warm caches
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.time()
            rows = cpu_contacts(batches, resids1, resids2, A1)
            best = min(best, time.time() - t0)
        print(f"{name}: {n_atoms:,} atoms, {n_frames} frames, "
              f"{len(rows['frames']):,} rows -> "
              f"{n_frames / best:.2f} frames/s "
              f"(best of {args.reps}, 1 CPU core)")
        if args.parity:
            from basicrta_tpu.config import ContactConfig
            from basicrta_tpu.contacts.mapper import MapContacts
            from basicrta_tpu.contacts.records import ContactMeta
            A2 = len(resids2)
            mc = MapContacts(indices1=np.arange(A1), resids1=resids1,
                             indices2=np.arange(A1, A1 + A2),
                             resids2=resids2, cfg=ContactConfig(),
                             meta=ContactMeta(ts=0.1))
            _check_parity(rows, mc.run(batches))


if __name__ == "__main__":
    main()
