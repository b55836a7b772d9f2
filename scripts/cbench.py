"""Interleaved A/B of contacts-mapper configurations on the device.

Quantifies the adaptive prefilter cap against a pinned static cap and
the dense kernel on bench.py's membrane-scale workload (300x16 vs
200x50 atoms, 120x120x90 A box). Variants interleave across reps so
that drift between runs hits every variant alike. Also cross-checks that every variant produced identical
contact rows (the adaptive cap must never change output).

Usage:
    python scripts/cbench.py [--reps 5] [--frames 96]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench as B  # noqa: E402  (reuses workload + jax cache config)
from basicrta_tpu.config import ContactConfig  # noqa: E402
from basicrta_tpu.contacts.mapper import MapContacts  # noqa: E402
from basicrta_tpu.contacts.records import ContactMeta  # noqa: E402

VARIANTS = {
    # forced prefilter, adaptive cap (auto keeps the dense kernel below
    # prefilter_auto_pairs since the 2026-08-19 A/B — pin it on here)
    "adaptive": ContactConfig(prefilter=True),
    # round-3 measured configuration: every batch at the full 4096 cap
    "static4096": ContactConfig(prefilter=True, prefilter_cap_min=4096),
    # the unpruned kernel (round-2 baseline path)
    "dense": ContactConfig(prefilter=False),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=96)
    args = ap.parse_args()

    B._preflight()
    batches, resids1, resids2, A1 = B.make_membrane_frames(
        n_frames=args.frames)
    n_frames = sum(len(b.frame_ids) for b in batches)
    A2 = len(resids2)

    mappers = {name: MapContacts(
        indices1=np.arange(A1), resids1=resids1,
        indices2=np.arange(A1, A1 + A2), resids2=resids2,
        cfg=cfg, meta=ContactMeta(ts=0.1))
        for name, cfg in VARIANTS.items()}

    recs = {}
    for name, mc in mappers.items():   # cold: compiles + cap warm-up
        recs[name] = mc.run(batches)
    ref = recs["dense"]
    for name, rec in recs.items():
        assert np.array_equal(rec.frames, ref.frames), name
        assert np.array_equal(rec.min_dist, ref.min_dist), name
    print(f"all variants agree: {len(ref.frames)} rows / "
          f"{n_frames} frames", flush=True)

    times = {name: [] for name in mappers}
    for rep in range(args.reps):
        for name, mc in mappers.items():
            t0 = time.time()
            mc.run(batches)
            times[name].append(time.time() - t0)
            print(f"rep {rep} {name}: "
                  f"{n_frames / times[name][-1]:,.1f} frames/s",
                  flush=True)
    print("\n== medians ==")
    for name, ts in times.items():
        med = float(np.median(ts))
        print(f"{name:12s} {n_frames / med:10,.1f} frames/s "
              f"(median of {args.reps})")


if __name__ == "__main__":
    main()
