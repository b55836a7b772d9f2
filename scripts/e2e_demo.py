#!/usr/bin/env python
"""End-to-end product-path demo: synthetic membrane system -> CLI stages.

Generates a GRO/XTC pair with planted binding kinetics (each lipid
alternates bound/unbound at its home protein residue with hyperexponential
bound durations), then drives the SAME four CLI entry points a user runs
(reference: python -m basicrta.{contacts,gibbs,cluster,kinetics}) and
reports per-stage wall-clock.

Usage: python scripts/e2e_demo.py [--workdir DIR] [--frames 5000]
       [--niter 110000] [--ndevices N]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from basicrta_tpu.jax_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def make_system(root: str, n_prot: int, n_lip: int, frames: int,
                ts: float, rng) -> None:
    """Write top.gro / traj.xtc / struct.pdb with planted kinetics."""
    from basicrta_tpu.io.native import XTCWriter
    from basicrta_tpu.io.topology import Topology, write_gro, write_pdb

    prot_at, lip_at = 4, 10
    box = np.array([150.0, 150.0, 100.0], np.float32)
    # protein residues on a grid in the membrane plane
    sites = np.stack([
        20.0 + 110.0 * (np.arange(n_prot) % 12) / 12.0,
        20.0 + 110.0 * (np.arange(n_prot) // 12) / 12.0,
        np.full(n_prot, 50.0)], axis=1).astype(np.float32)

    names, resids, resnames = [], [], []
    for r in range(n_prot):
        for a in range(prot_at):
            names.append(f"C{a}")
            resids.append(r + 1)
            resnames.append("TRP" if r % 7 == 0 else "LEU")
    for l in range(n_lip):
        for a in range(lip_at):
            names.append(f"L{a}")
            resids.append(1000 + l)
            resnames.append("CHOL")
    A = len(names)
    top = Topology(np.array(names), np.array(resids, np.int32),
                   np.array(resnames), np.zeros((A, 3), np.float32), box)
    write_gro(os.path.join(root, "top.gro"), top)
    write_pdb(os.path.join(root, "struct.pdb"), top)

    pos = np.empty((frames, A, 3), np.float32)
    # protein: small jitter around sites
    for r in range(n_prot):
        base = sites[r]
        offs = rng.normal(0.0, 0.4, (prot_at, 3)).astype(np.float32)
        pos[:, r * prot_at:(r + 1) * prot_at] = (
            base + offs + rng.normal(0.0, 0.15,
                                     (frames, prot_at, 3))).astype(
                                         np.float32)
    # lipids: alternate bound (at home site) / away, hyperexp bound times
    w_true = np.array([0.75, 0.25])
    r_true = np.array([2.0, 0.2])          # 1/ns
    p0 = n_prot * prot_at
    for l in range(n_lip):
        home = sites[l % n_prot]
        away = home + np.array([0.0, 0.0, 35.0], np.float32)
        f = 0
        bound = bool(rng.integers(0, 2))
        center = np.empty((frames, 3), np.float32)
        while f < frames:
            if bound:
                comp = rng.choice(2, p=w_true)
                dur_ns = rng.exponential(1.0 / r_true[comp])
            else:
                dur_ns = rng.exponential(1.5)
            n = max(1, int(round(dur_ns / ts)))
            center[f:f + n] = home + [2.5, 0.0, 0.0] if bound else away
            f += n
            bound = not bound
        offs = rng.normal(0.0, 0.8, (lip_at, 3)).astype(np.float32)
        pos[:, p0 + l * lip_at:p0 + (l + 1) * lip_at] = (
            center[:, None, :] + offs
            + rng.normal(0.0, 0.2, (frames, lip_at, 3))).astype(np.float32)

    XTCWriter(os.path.join(root, "traj.xtc")).write(
        pos, (np.arange(frames) * ts).astype(np.float64),
        np.tile(box, (frames, 1)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="basicrta_e2e")
    ap.add_argument("--frames", type=int, default=5000)
    ap.add_argument("--nprot", type=int, default=120)
    ap.add_argument("--nlip", type=int, default=60)
    ap.add_argument("--niter", type=int, default=110_000)
    ap.add_argument("--ndevices", type=int, default=None)
    args = ap.parse_args()

    from basicrta_tpu.cli import main as cli

    root = args.workdir
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(7)
    t0 = time.time()
    make_system(root, args.nprot, args.nlip, args.frames, 0.1, rng)
    print(f"[gen]      {time.time() - t0:6.1f}s  "
          f"{args.frames} frames, {args.nprot} residues, {args.nlip} lipids")

    os.chdir(root)
    stages = [
        ("contacts", ["contacts", "--top", "top.gro", "--traj", "traj.xtc",
                      "--sel1", "protein", "--sel2", "resname CHOL",
                      "--cutoff", "7.0", "--batch", "128"]),
        ("gibbs", ["gibbs", "--contacts", "contacts_7.0.npz",
                   "--niter", str(args.niter)]),
        ("cluster", ["cluster", "--cutoff", "7.0",
                     "--niter", str(args.niter),
                     "--structure", "struct.pdb"]),
        ("kinetics", ["kinetics",
                      "--gibbs",
                      f"basicrta-7.0/W1/gibbs_{args.niter}.npz",
                      "--contacts", "contacts_7.0.npz", "--wdensity"]),
    ]
    for name, argv in stages:
        if args.ndevices is not None and name in ("contacts", "gibbs"):
            argv += ["--ndevices", str(args.ndevices)]
        t0 = time.time()
        cli(argv)
        print(f"[{name:8s}] {time.time() - t0:6.1f}s")
    print("e2e OK:", root)


if __name__ == "__main__":
    main()
