"""Tests for contact extraction and residence-event merging."""

import os

import numpy as np
import pytest

from basicrta_tpu.config import ContactConfig
from basicrta_tpu.contacts.records import (ContactMeta, ContactRecords,
                                           ContactEvents)
from basicrta_tpu.contacts.events import merge_events
from basicrta_tpu.contacts.distances import (group_by_residue, gather_grouped,
                                             min_dist_per_residue_pair)
from basicrta_tpu.contacts.mapper import FrameBatch, MapContacts, \
    ProcessContacts

import jax.numpy as jnp


def _records(rows, ts=0.1, cutoff=10.0):
    """rows: list of (frame, s1, s2, dist)."""
    rows = np.asarray(rows, dtype=float)
    return ContactRecords(
        frames=rows[:, 0].astype(np.int64),
        sel1_resids=rows[:, 1].astype(np.int32),
        sel2_resids=rows[:, 2].astype(np.int32),
        min_dist=rows[:, 3].astype(np.float32),
        times=rows[:, 0] * ts,
        meta=ContactMeta(ts=ts, cutoff=cutoff))


class TestMergeEvents:
    """Golden tests of the _lipswap-equivalent merging
    (reference contacts.py:197-231)."""

    def test_single_run(self):
        rec = _records([(5, 1, 100, 3.0), (6, 1, 100, 3.0), (7, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 1
        assert ev.sel1_resids[0] == 1 and ev.sel2_resids[0] == 100
        assert ev.start_times[0] == pytest.approx(0.5)
        assert ev.durations[0] == pytest.approx(0.3)  # 3 frames * ts

    def test_isolated_single_frame(self):
        # isolated contact -> duration ts (reference contacts.py:216-217,227)
        rec = _records([(2, 1, 100, 3.0), (10, 1, 100, 3.0),
                        (11, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 2
        assert ev.durations[0] == pytest.approx(0.1)
        assert ev.start_times[0] == pytest.approx(0.2)
        assert ev.durations[1] == pytest.approx(0.2)

    def test_gap_breaks_run(self):
        rec = _records([(1, 1, 100, 3.0), (2, 1, 100, 3.0),
                        (4, 1, 100, 3.0), (5, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 2
        assert np.allclose(ev.start_times, [0.1, 0.4])
        assert np.allclose(ev.durations, [0.2, 0.2])

    def test_pair_change_breaks_run(self):
        # same frames, different sel2 residue -> separate events
        rec = _records([(1, 1, 100, 3.0), (2, 1, 101, 3.0),
                        (3, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 3

    def test_random_agrees_with_bruteforce(self, rng):
        """Property test: random contact tables vs an independent python
        brute-force run-length merge (many pairs, gaps, singles, and
        sub/super-cutoff rows interleaved)."""
        ts = 0.1
        for trial in range(5):
            frames, s1s, s2s, dists = [], [], [], []
            for r1 in (1, 2, 3):
                for r2 in (100, 101):
                    hit = rng.random(40) < 0.45
                    f = np.nonzero(hit)[0]
                    frames.append(f)
                    s1s.append(np.full(len(f), r1))
                    s2s.append(np.full(len(f), r2))
                    # ~1/4 of rows land beyond the analysis cutoff
                    dists.append(np.where(rng.random(len(f)) < 0.25,
                                          8.5, 3.0))
            order = np.argsort(np.concatenate(frames), kind="stable")
            rows = np.stack([np.concatenate(frames),
                             np.concatenate(s1s), np.concatenate(s2s),
                             np.concatenate(dists)], axis=1)[order]
            rec = _records([tuple(r) for r in rows])
            ev = merge_events(rec, 7.0)

            # brute force: per pair, walk sorted frames, split on gaps
            expected = []
            keep = rows[rows[:, 3] <= 7.0]
            for r1 in (1, 2, 3):
                for r2 in (100, 101):
                    f = np.sort(keep[(keep[:, 1] == r1)
                                     & (keep[:, 2] == r2), 0]).astype(int)
                    i = 0
                    while i < len(f):
                        j = i
                        while j + 1 < len(f) and f[j + 1] == f[j] + 1:
                            j += 1
                        expected.append((r1, r2, f[i] * ts,
                                         (j - i + 1) * ts))
                        i = j + 1
            got = sorted(zip(ev.sel1_resids, ev.sel2_resids,
                             ev.start_times, ev.durations))
            exp = sorted(expected)
            assert len(got) == len(exp), trial
            for g, e in zip(got, exp):
                assert g[0] == e[0] and g[1] == e[1]
                assert g[2] == pytest.approx(e[2])
                assert g[3] == pytest.approx(e[3])

    def test_cutoff_filter(self):
        # distances above the analysis cutoff break the run
        rec = _records([(1, 1, 100, 3.0), (2, 1, 100, 8.5),
                        (3, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 2
        assert np.allclose(ev.durations, [0.1, 0.1])

    def test_empty(self):
        rec = _records([(1, 1, 100, 9.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 0

    def test_multiple_pairs_interleaved(self):
        rec = _records([(1, 1, 100, 3.0), (1, 2, 100, 3.0),
                        (2, 1, 100, 3.0), (2, 2, 100, 3.0),
                        (3, 2, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        assert len(ev) == 2
        d = {(int(a), int(b)): dur for a, b, dur in
             zip(ev.sel1_resids, ev.sel2_resids, ev.durations)}
        assert d[(1, 100)] == pytest.approx(0.2)
        assert d[(2, 100)] == pytest.approx(0.3)

    def test_roundtrip_npz(self, tmp_path):
        rec = _records([(1, 1, 100, 3.0), (2, 1, 100, 3.0)])
        ev = merge_events(rec, 7.0)
        p = ev.save(str(tmp_path / "events.npz"))
        ev2 = ContactEvents.load(p)
        assert np.allclose(ev2.durations, ev.durations)
        assert ev2.meta.cutoff == 7.0
        rows = ev2.as_rows()
        assert rows.shape == (1, 4)


class TestDistances:
    def test_matches_bruteforce_pbc(self, rng):
        F, A1, A2 = 3, 17, 23
        box = np.array([20.0, 25.0, 30.0])
        pos = rng.uniform(0, 30, (F, A1 + A2, 3)).astype(np.float32)
        resids1 = np.repeat(np.arange(4), [5, 4, 5, 3])
        resids2 = np.repeat(np.arange(5) + 100, [5, 5, 5, 5, 3])

        idx1, u1 = group_by_residue(resids1)
        idx2, u2 = group_by_residue(resids2)
        p1, m1 = gather_grouped(jnp.asarray(pos[:, :A1]), idx1)
        p2, m2 = gather_grouped(jnp.asarray(pos[:, A1:]), idx2)
        d = np.asarray(min_dist_per_residue_pair(
            p1, p2, jnp.tile(jnp.asarray(box, jnp.float32), (F, 1)),
            chunk=3, mask1=m1, mask2=m2))

        # brute force
        delta = pos[:, :A1, None, :] - pos[:, None, A1:, :]
        delta -= box * np.round(delta / box)
        dist = np.sqrt((delta ** 2).sum(-1))     # (F, A1, A2)
        for f in range(F):
            for i, r1 in enumerate(u1):
                for j, r2 in enumerate(u2):
                    ref = dist[f][np.ix_(resids1 == r1, resids2 == r2)].min()
                    assert d[f, i, j] == pytest.approx(ref, rel=1e-4)

    def test_no_pbc(self, rng):
        pos1 = rng.uniform(0, 5, (1, 1, 1, 3)).astype(np.float32)
        pos2 = pos1 + np.array([19.0, 0, 0], dtype=np.float32)
        d_pbc = np.asarray(min_dist_per_residue_pair(
            jnp.asarray(pos1), jnp.asarray(pos2),
            jnp.full((1, 3), 20.0), use_pbc=True))
        d_free = np.asarray(min_dist_per_residue_pair(
            jnp.asarray(pos1), jnp.asarray(pos2), use_pbc=False))
        assert d_pbc[0, 0, 0] == pytest.approx(1.0, abs=1e-3)
        assert d_free[0, 0, 0] == pytest.approx(19.0, abs=1e-3)


class TestTriclinicMIC:
    """General minimum-image agreement against a brute-force image search
    (capped_distance parity on triclinic dimensions, reference
    contacts.py:115-117)."""

    @staticmethod
    def _random_reduced_box(rng):
        """GROMACS-reduced triclinic box: a=(ax,0,0), b=(bx,by,0),
        c=(cx,cy,cz) with |bx|,|cx| <= ax/2 and |cy| <= by/2."""
        ax, by, cz = rng.uniform(20, 40, 3)
        H = np.zeros((3, 3))
        H[0, 0] = ax
        H[1] = [rng.uniform(-ax / 2, ax / 2), by, 0.0]
        H[2] = [rng.uniform(-ax / 2, ax / 2), rng.uniform(-by / 2, by / 2),
                cz]
        return H

    def test_agrees_with_bruteforce(self, rng):
        F, n1, n2 = 3, 6, 5
        mins_kernel = []
        mins_brute = []
        boxes = np.stack([self._random_reduced_box(rng) for _ in range(F)])
        # points spread well beyond one cell to exercise wrapping
        p1 = rng.uniform(-60, 60, (F, n1, 1, 3)).astype(np.float32)
        p2 = rng.uniform(-60, 60, (F, n2, 1, 3)).astype(np.float32)
        out = np.asarray(min_dist_per_residue_pair(
            jnp.asarray(p1), jnp.asarray(p2),
            jnp.asarray(boxes, jnp.float32), triclinic=True))
        # brute force over a generous 11^3 image search in f64 (points span
        # several cells, so the search must reach well past the separation)
        shifts = np.array([[i, j, k] for i in range(-5, 6)
                           for j in range(-5, 6) for k in range(-5, 6)])
        for f in range(F):
            img = shifts @ boxes[f]                      # (125, 3)
            d = (p1[f, :, 0][:, None, None, :] - p2[f, :, 0][None, :, None, :]
                 + img[None, None, :, :])
            brute = np.sqrt((d ** 2).sum(-1)).min(-1)    # (n1, n2)
            assert np.allclose(out[f], brute, atol=2e-3), (
                np.abs(out[f] - brute).max())

    def test_orthorhombic_box_matches_diagonal_path(self, rng):
        F, n1, n2 = 2, 4, 3
        L = np.array([30.0, 40.0, 50.0], np.float32)
        H = np.tile(np.diag(L), (F, 1, 1))
        p1 = rng.uniform(-80, 80, (F, n1, 1, 3)).astype(np.float32)
        p2 = rng.uniform(-80, 80, (F, n2, 1, 3)).astype(np.float32)
        tri = np.asarray(min_dist_per_residue_pair(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(H),
            triclinic=True))
        ortho = np.asarray(min_dist_per_residue_pair(
            jnp.asarray(p1), jnp.asarray(p2),
            jnp.asarray(np.tile(L, (F, 1)))))
        assert np.allclose(tri, ortho, atol=1e-4)


class TestBoxConversion:
    def test_xtc_matrix_passthrough(self):
        from basicrta_tpu.io.universe import _box_from_matrix
        diag = np.tile(np.diag([30.0, 40.0, 50.0]), (2, 1, 1)).astype(
            np.float32)
        out = _box_from_matrix(diag)
        assert out.shape == (2, 3) and np.allclose(out, [30, 40, 50])
        tric = diag.copy()
        tric[:, 1, 0] = 15.0   # dodecahedron-like tilt
        out = _box_from_matrix(tric)
        assert out.shape == (2, 3, 3)

    def test_dcd_unitcell_triclinic(self):
        from basicrta_tpu.io.universe import _box_from_unitcell
        # orthorhombic: zero cosines
        cell = np.array([[30.0, 0.0, 40.0, 0.0, 0.0, 50.0]])
        out = _box_from_unitcell(cell)
        assert out.shape == (1, 3) and np.allclose(out, [30, 40, 50])
        # 60-degree gamma as cosine, CHARMM-style
        cell = np.array([[30.0, 0.5, 40.0, 0.0, 0.0, 50.0]])
        H = _box_from_unitcell(cell)
        assert H.shape == (1, 3, 3)
        assert H[0, 1, 0] == pytest.approx(20.0)           # B cos(gamma)
        assert np.linalg.norm(H[0, 1]) == pytest.approx(40.0)
        # degrees convention also accepted
        cell = np.array([[30.0, 60.0, 40.0, 90.0, 90.0, 50.0]])
        H2 = _box_from_unitcell(cell)
        assert np.allclose(H, H2, atol=1e-4)


class TestMapContacts:
    def test_end_to_end(self):
        """Two 2-atom residues vs one 3-atom ligand; contact windows known."""
        ts = 0.1
        nframes = 12
        A = 7  # atoms: res1(2) res2(2) lig(3)
        pos = np.full((nframes, A, 3), 0.0, np.float32)
        pos[:, 0:2, :] = [0.0, 0.0, 0.0]
        pos[:, 1, 0] = 1.0
        pos[:, 2:4, :] = [50.0, 0.0, 0.0]
        pos[:, 3, 0] = 51.0
        # ligand far away by default
        pos[:, 4:7, :] = [25.0, 25.0, 25.0]
        # frames 2-4: ligand near residue 1 (atom 0); frame 8: isolated touch
        for f in (2, 3, 4):
            pos[f, 4:7] = [2.0, 0.0, 0.0]
        pos[8, 4:7] = [49.0, 0.0, 0.0]  # near residue 2

        mc = MapContacts(
            indices1=np.arange(4), resids1=np.array([1, 1, 2, 2]),
            indices2=np.array([4, 5, 6]), resids2=np.array([9, 9, 9]),
            cfg=ContactConfig(map_cutoff=10.0, use_pbc=False),
            meta=ContactMeta(ts=ts, sel1="protein", sel2="resname LIG"))
        batches = [FrameBatch(np.arange(0, 6), np.arange(0, 6) * ts,
                              pos[:6]),
                   FrameBatch(np.arange(6, 12), np.arange(6, 12) * ts,
                              pos[6:])]
        rec = mc.run(batches)
        assert len(rec) == 4  # 3 frames near res1 + 1 near res2
        assert rec.meta.ts == pytest.approx(ts)

        ev = ProcessContacts(cutoff=7.0).run(rec)
        assert len(ev) == 2
        d = {(int(a), int(b)): (s, dur) for a, b, s, dur in
             zip(ev.sel1_resids, ev.sel2_resids, ev.start_times,
                 ev.durations)}
        assert d[(1, 9)][0] == pytest.approx(0.2)
        assert d[(1, 9)][1] == pytest.approx(0.3)
        assert d[(2, 9)][1] == pytest.approx(0.1)
        # Gibbs input extraction
        assert np.allclose(ev.times_for_residue(1), [0.3])

    @staticmethod
    def _tiny_mapper():
        return MapContacts(
            indices1=np.array([0]), resids1=np.array([1]),
            indices2=np.array([1]), resids2=np.array([9]),
            cfg=ContactConfig(map_cutoff=10.0, use_pbc=False))

    @staticmethod
    def _batches_for(times, split):
        pos = np.zeros((len(times), 2, 3), np.float32)
        pos[:, 1, 0] = 2.0
        times = np.asarray(times, np.float64)
        ids = np.arange(len(times))
        return [FrameBatch(ids[:split], times[:split], pos[:split]),
                FrameBatch(ids[split:], times[split:], pos[split:])]

    def test_ts_inferred_despite_one_frame_first_batch(self):
        """ts must come from the full frame-time vector; a first batch of a
        single frame starved the old first-two-frames guess."""
        mc = self._tiny_mapper()
        rec = mc.run(self._batches_for([0.0, 0.1, 0.2, 0.3], split=1))
        assert rec.meta.ts == pytest.approx(0.1)

    def test_irregular_stride_raises(self):
        mc = self._tiny_mapper()
        with pytest.raises(ValueError, match="irregular"):
            mc.run(self._batches_for([0.0, 0.1, 0.3, 0.4], split=2))

    def test_float32_quantized_times_accepted(self):
        """Trajectory formats store times as float32; a long regular
        trajectory's gaps jitter by ~|t| 2^-23 and must still infer a
        clean ts (regression: a 1e-4 max/min tolerance rejected any real
        trajectory past ~2000 frames)."""
        F, ts = 5000, 0.1
        times = (np.arange(F) * ts).astype(np.float32).astype(np.float64)
        mc = self._tiny_mapper()
        rec = mc.run(self._batches_for(times, split=1717))
        assert rec.meta.ts == pytest.approx(ts, rel=1e-4)

    def test_frame_sharded_matches_unsharded(self):
        """n_devices shards the frame axis over the mesh (the counterpart
        of the reference's trajectory-slice pool,
        contacts.py:60-75); results are identical to one device."""
        ts = 0.1
        rng = np.random.default_rng(8)
        F, A = 37, 6   # deliberately not a multiple of 8 devices
        pos = rng.uniform(0, 50, (F, A, 3)).astype(np.float32)
        ids = np.arange(F)
        batch = [FrameBatch(ids, ids * ts, pos,
                            np.tile([50.0] * 3, (F, 1)))]
        kw = dict(indices1=np.arange(3), resids1=np.array([1, 1, 2]),
                  indices2=np.arange(3, 6), resids2=np.array([9, 9, 10]),
                  cfg=ContactConfig(map_cutoff=30.0))
        ref = MapContacts(**kw).run(
            [FrameBatch(ids, ids * ts, pos, np.tile([50.0] * 3, (F, 1)))])
        sharded = MapContacts(**kw, n_devices=0).run(batch)
        assert len(ref) == len(sharded)
        assert np.array_equal(ref.frames, sharded.frames)
        assert np.allclose(ref.min_dist, sharded.min_dist, atol=1e-5)

    def test_explicit_ts_bypasses_inference(self):
        mc = self._tiny_mapper()
        mc.meta = ContactMeta(ts=0.05)
        rec = mc.run(self._batches_for([0.0, 0.1, 0.3, 0.4], split=2))
        assert rec.meta.ts == pytest.approx(0.05)


class TestCompactContacts:
    """Device-side contact compaction (distances.compact_contacts): only
    sub-cutoff entries cross the host link; rows must be bit-identical to
    the dense path, with an exact dense fallback on cap overflow."""

    def test_compact_reconstructs_dense_rows(self, rng):
        from basicrta_tpu.contacts.distances import (compact_contacts,
                                                     contacts_from_batch)
        F, R1, R2 = 4, 20, 30
        dmin = rng.uniform(0.0, 30.0, (F, R1, R2)).astype(np.float32)
        cutoff = 10.0
        n, idx, dist = (np.asarray(a) for a in
                        compact_contacts(jnp.asarray(dmin), cutoff, 512))
        assert np.array_equal(n, (dmin <= cutoff).sum(axis=(1, 2)))
        fk, kk = np.nonzero(dist <= cutoff)
        flat = idx[fk, kk]
        order = np.lexsort((flat, fk))
        fk, flat = fk[order], flat[order]
        got = np.stack([fk, flat // R2, flat % R2], axis=1)
        f, s1, s2, d, _ = contacts_from_batch(
            dmin, np.arange(F), np.arange(F, dtype=float),
            np.arange(R1), np.arange(R2), cutoff)
        np.testing.assert_array_equal(got, np.stack([f, s1, s2], axis=1))
        np.testing.assert_array_equal(
            dist[fk, kk[order]], d)  # exact f32 values survive top_k

    def test_overflow_detected(self, rng):
        from basicrta_tpu.contacts.distances import compact_contacts
        dmin = np.full((2, 4, 4), 1.0, np.float32)   # every pair is a hit
        n, idx, dist = compact_contacts(jnp.asarray(dmin), 5.0, 8)
        assert np.all(np.asarray(n) == 16) and np.all(np.asarray(n) > 8)

    def _system(self, rng, transfer_cap):
        """4x2-residue system, n_pairs=8; per-frame hits controlled."""
        ts = 0.1
        F = 6
        A = 6  # sel1: 4 single-atom residues; sel2: 2 single-atom
        pos = np.zeros((F, A, 3), np.float32)
        pos[:, 0] = [0.0, 0.0, 0.0]
        pos[:, 1] = [30.0, 0.0, 0.0]
        pos[:, 2] = [0.0, 30.0, 0.0]
        pos[:, 3] = [30.0, 30.0, 0.0]
        pos[:, 4] = [100.0, 100.0, 100.0]
        pos[:, 5] = [120.0, 100.0, 100.0]
        # frame 1: lig A near residue 1 only; frame 3: lig A near all four
        # residues (4 hits) + lig B near residues 1-2 (2 hits) -> 6 hits
        pos[1, 4] = [2.0, 0.0, 0.0]
        pos[3, 4] = [15.0, 15.0, 0.0]
        pos[3, 5] = [15.0, 0.0, 0.0]
        mc = MapContacts(
            indices1=np.arange(4), resids1=np.array([1, 2, 3, 4]),
            indices2=np.array([4, 5]), resids2=np.array([9, 10]),
            cfg=ContactConfig(map_cutoff=25.0, use_pbc=False,
                              transfer_cap=transfer_cap),
            meta=ContactMeta(ts=ts))
        return mc.run([FrameBatch(np.arange(F), np.arange(F) * ts, pos)])

    def test_mapper_compact_matches_dense(self, rng):
        dense = self._system(rng, transfer_cap=4096)   # n_pairs<=cap: dense
        # cap 7 < n_pairs 8 activates compaction; max 6 hits/frame fits ->
        # the pure compact path. cap 4 overflows on frame 3 -> exact
        # dense-fallback path. All three must be bit-identical.
        compact = self._system(rng, transfer_cap=7)
        overflow = self._system(rng, transfer_cap=4)
        for rec in (compact, overflow):
            np.testing.assert_array_equal(rec.frames, dense.frames)
            np.testing.assert_array_equal(rec.sel1_resids, dense.sel1_resids)
            np.testing.assert_array_equal(rec.sel2_resids, dense.sel2_resids)
            np.testing.assert_array_equal(rec.min_dist, dense.min_dist)


class TestPrefilter:
    """Bounding-sphere pruning (distances.min_dist_pruned): exact parity
    with the dense kernel — dropped pairs are provably beyond the cutoff
    (VERDICT round 2 item 2)."""

    def _random_system(self, rng, F=4, R1=8, P1=5, R2=6, P2=4, spread=24.0):
        resids1 = np.repeat(np.arange(R1), P1)
        resids2 = np.repeat(np.arange(R2) + 100, P2)
        # clustered residues (compact bounding spheres) scattered in a box
        c1 = rng.uniform(0, spread, (F, R1, 3))
        c2 = rng.uniform(0, spread, (F, R2, 3))
        pos1 = (c1[:, :, None, :]
                + rng.normal(0, 1.0, (F, R1, P1, 3))).reshape(F, R1 * P1, 3)
        pos2 = (c2[:, :, None, :]
                + rng.normal(0, 1.0, (F, R2, P2, 3))).reshape(F, R2 * P2, 3)
        pos = np.concatenate([pos1, pos2], axis=1).astype(np.float32)
        return pos, resids1, resids2, R1 * P1

    @pytest.mark.parametrize("use_pbc", [False, True])
    def test_pruned_matches_dense_kernel(self, rng, use_pbc):
        from basicrta_tpu.contacts.distances import min_dist_pruned
        pos, resids1, resids2, A1 = self._random_system(rng)
        F = len(pos)
        box = np.tile(np.array([25.0, 28.0, 30.0], np.float32), (F, 1))
        idx1, u1 = group_by_residue(resids1)
        idx2, u2 = group_by_residue(resids2)
        p1, m1 = gather_grouped(jnp.asarray(pos[:, :A1]), idx1)
        p2, m2 = gather_grouped(jnp.asarray(pos[:, A1:]), idx2)
        boxj = jnp.asarray(box) if use_pbc else None
        cutoff = 8.0
        dense = np.asarray(min_dist_per_residue_pair(
            p1, p2, boxj, use_pbc=use_pbc, mask1=m1, mask2=m2))
        n_pl, idx, dist = (np.asarray(a) for a in min_dist_pruned(
            p1, p2, cutoff, boxj, cap_pairs=64, chunk=16,
            use_pbc=use_pbc, mask1=m1, mask2=m2))
        R2 = len(u2)
        cap = dist.shape[1]
        assert (n_pl <= cap).all()
        got = {}
        for f in range(F):
            for k in range(cap):
                if np.isfinite(dist[f, k]):
                    got[(f, idx[f, k] // R2, idx[f, k] % R2)] = dist[f, k]
        # every dense sub-cutoff pair must be present with the same value
        for f in range(F):
            for i in range(len(u1)):
                for j in range(R2):
                    if dense[f, i, j] <= cutoff:
                        assert (f, i, j) in got
                        assert got[(f, i, j)] == pytest.approx(
                            dense[f, i, j], rel=1e-5)

    def test_pruned_matches_dense_triclinic(self, rng):
        from basicrta_tpu.contacts.distances import min_dist_pruned
        pos, resids1, resids2, A1 = self._random_system(rng, spread=18.0)
        F = len(pos)
        H = np.zeros((3, 3), np.float32)
        H[0] = [22.0, 0, 0]
        H[1] = [8.0, 24.0, 0]
        H[2] = [-6.0, 7.0, 26.0]
        box = np.tile(H, (F, 1, 1))
        idx1, u1 = group_by_residue(resids1)
        idx2, u2 = group_by_residue(resids2)
        p1, m1 = gather_grouped(jnp.asarray(pos[:, :A1]), idx1)
        p2, m2 = gather_grouped(jnp.asarray(pos[:, A1:]), idx2)
        cutoff = 7.0
        dense = np.asarray(min_dist_per_residue_pair(
            p1, p2, jnp.asarray(box), mask1=m1, mask2=m2, triclinic=True))
        n_pl, idx, dist = (np.asarray(a) for a in min_dist_pruned(
            p1, p2, cutoff, jnp.asarray(box), cap_pairs=64, chunk=16,
            mask1=m1, mask2=m2, triclinic=True))
        R2 = len(u2)
        hits = 0
        for f in range(F):
            sl = {}
            for k in range(dist.shape[1]):
                if np.isfinite(dist[f, k]):
                    sl[(idx[f, k] // R2, idx[f, k] % R2)] = dist[f, k]
            for i in range(len(u1)):
                for j in range(R2):
                    if dense[f, i, j] <= cutoff:
                        hits += 1
                        assert sl[(i, j)] == pytest.approx(dense[f, i, j],
                                                           rel=1e-5)
        assert hits > 0   # the system must actually produce contacts

    def test_mapper_prefilter_matches_dense(self, rng):
        """End-to-end MapContacts parity: prefilter on vs off, including
        the cap-overflow dense fallback."""
        pos, resids1, resids2, A1 = self._random_system(rng, F=6)
        ts = 0.1
        box = np.tile(np.array([25.0, 28.0, 30.0], np.float32), (6, 1))

        def run(prefilter, cap=4096):
            mc = MapContacts(
                indices1=np.arange(A1), resids1=resids1,
                indices2=np.arange(A1, pos.shape[1]), resids2=resids2,
                cfg=ContactConfig(map_cutoff=10.0, prefilter=prefilter,
                                  prefilter_cap=cap),
                meta=ContactMeta(ts=ts))
            return mc.run([FrameBatch(np.arange(6), np.arange(6) * ts,
                                      pos, box=box)])

        dense = run(False)
        pruned = run(True)
        overflow = run(True, cap=4)   # forces the dense-fallback path
        assert len(dense.frames) > 0
        for rec in (pruned, overflow):
            np.testing.assert_array_equal(rec.frames, dense.frames)
            np.testing.assert_array_equal(rec.sel1_resids, dense.sel1_resids)
            np.testing.assert_array_equal(rec.sel2_resids, dense.sel2_resids)
            np.testing.assert_allclose(rec.min_dist, dense.min_dist,
                                       rtol=1e-5)

    def test_adaptive_cap_growth_is_exact(self, rng):
        """The adaptive prefilter cap starts at prefilter_cap_min and grows
        through undershoot-retries without changing a single row: a dense
        cluster (hundreds of plausible pairs/frame) overflows the initial
        cap, later sparse batches keep the grown cap."""
        F, R1, P1, R2, P2 = 3, 12, 3, 10, 3
        resids1 = np.repeat(np.arange(R1), P1)
        resids2 = np.repeat(np.arange(R2) + 100, P2)
        A1 = R1 * P1
        ts = 0.1

        def frames(spread):
            c1 = rng.uniform(0, spread, (F, R1, 3))
            c2 = rng.uniform(0, spread, (F, R2, 3))
            p1 = (c1[:, :, None] + rng.normal(0, 0.5, (F, R1, P1, 3)))
            p2 = (c2[:, :, None] + rng.normal(0, 0.5, (F, R2, P2, 3)))
            return np.concatenate([p1.reshape(F, -1, 3),
                                   p2.reshape(F, -1, 3)],
                                  axis=1).astype(np.float32)

        # batch 1: everything piled into a 6 A box -> all 120 residue
        # pairs plausible (>> cap_min 16); batch 2: sparse
        pos_dense = frames(spread=6.0)
        pos_sparse = frames(spread=60.0)
        batches = lambda: [
            FrameBatch(np.arange(F), np.arange(F) * ts, pos_dense),
            FrameBatch(np.arange(F, 2 * F), np.arange(F, 2 * F) * ts,
                       pos_sparse)]

        def run(prefilter):
            mc = MapContacts(
                indices1=np.arange(A1), resids1=resids1,
                indices2=np.arange(A1, A1 + R2 * P2), resids2=resids2,
                cfg=ContactConfig(map_cutoff=10.0, prefilter=prefilter,
                                  prefilter_cap_min=16, use_pbc=False),
                meta=ContactMeta(ts=ts))
            return mc.run(batches())

        dense, pruned = run(False), run(True)
        assert len(dense.frames) > R1 * R2  # the pile really is dense
        np.testing.assert_array_equal(pruned.frames, dense.frames)
        np.testing.assert_array_equal(pruned.sel1_resids, dense.sel1_resids)
        np.testing.assert_array_equal(pruned.sel2_resids, dense.sel2_resids)
        np.testing.assert_allclose(pruned.min_dist, dense.min_dist,
                                   rtol=1e-5)


class TestColumnStore:
    """Host-memory valve: contact rows spill to disk memmaps past the row
    budget (reference contacts.py:45-48,86-92 parity)."""

    def test_spill_roundtrip(self, rng, tmp_path):
        from basicrta_tpu.contacts.mapper import _ColumnStore
        ram = _ColumnStore(budget_rows=0)
        spill = _ColumnStore(budget_rows=100, spill_dir=str(tmp_path))
        chunks = []
        for _ in range(7):
            n = int(rng.integers(20, 80))
            chunk = (rng.integers(0, 1000, n), rng.integers(0, 50, n),
                     rng.integers(100, 150, n),
                     rng.uniform(0, 10, n).astype(np.float32),
                     rng.uniform(0, 99.0, n))
            chunks.append(chunk)
            ram.append(*chunk)
            spill.append(*chunk)
        assert spill.spilled and not ram.spilled
        a, b = ram.finalize(), spill.finalize()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
            assert a[k].dtype == b[k].dtype
        assert isinstance(b["frames"], np.memmap)
        # spill files are unlinked immediately (no litter)
        assert not [p for p in tmp_path.iterdir()
                    if p.name.startswith(".contacts_")]

    def test_mapper_spill_matches_in_ram(self, rng):
        pos, resids1, resids2, A1 = TestPrefilter()._random_system(rng, F=6)
        box = np.tile(np.array([25.0, 28.0, 30.0], np.float32), (6, 1))

        def run(budget):
            mc = MapContacts(
                indices1=np.arange(A1), resids1=resids1,
                indices2=np.arange(A1, pos.shape[1]), resids2=resids2,
                cfg=ContactConfig(map_cutoff=10.0, host_row_budget=budget),
                meta=ContactMeta(ts=0.1))
            return mc.run([FrameBatch(np.arange(3), np.arange(3) * 0.1,
                                      pos[:3], box=box[:3]),
                           FrameBatch(np.arange(3, 6),
                                      np.arange(3, 6) * 0.1,
                                      pos[3:], box=box[3:])])

        a, b = run(0), run(1)   # budget 1 row -> spills every batch
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(a.min_dist, b.min_dist)
        np.testing.assert_array_equal(a.times, b.times)


class TestMergeRegressions:
    """Regressions from the contacts/ops code review."""

    def _records(self, frames, times, ts):
        from basicrta_tpu.contacts.records import (ContactMeta,
                                                   ContactRecords)
        n = len(frames)
        return ContactRecords(
            np.asarray(frames, np.int64),
            np.full(n, 10, np.int32), np.full(n, 100, np.int32),
            np.full(n, 3.0, np.float32), np.asarray(times, np.float64),
            ContactMeta(ts=ts))

    def test_integral_timestep_events(self):
        """ts = 1.0 ns: two separate 2-frame events must stay separate
        (the old decimals_of(-2) rounding collapsed all times < 50 ns)."""
        from basicrta_tpu.contacts.events import merge_events
        rec = self._records([0, 1, 10, 11], [0.0, 1.0, 10.0, 11.0], 1.0)
        ev = merge_events(rec, 7.0)
        assert len(ev.durations) == 2
        assert np.allclose(sorted(ev.durations), [2.0, 2.0])
        assert np.allclose(sorted(ev.start_times), [0.0, 10.0])

    def test_chained_restarted_clock_events(self):
        """Runs key on GLOBAL frame indices: duplicate per-segment times
        (restarted clocks) must not merge distant events."""
        from basicrta_tpu.contacts.events import merge_events
        # segment A frames 0-1 (times 0.0, 0.1), segment B global frames
        # 10-11 whose local clock restarted (times 0.0, 0.1 again)
        rec = self._records([0, 1, 10, 11], [0.0, 0.1, 0.0, 0.1], 0.1)
        ev = merge_events(rec, 7.0)
        assert len(ev.durations) == 2
        assert np.allclose(ev.durations, [0.2, 0.2])


class TestCheckpointResume:
    """MapContacts durable mid-scan checkpoints: a preempted scan rerun
    with the same inputs resumes from the last checkpoint and produces
    the identical ContactRecords (the reference restarts from frame 0)."""

    @staticmethod
    def _mapper(map_cutoff=10.0):
        return MapContacts(
            indices1=np.arange(6), resids1=np.array([1, 1, 2, 2, 3, 3]),
            indices2=np.arange(6, 10), resids2=np.array([8, 8, 9, 9]),
            cfg=ContactConfig(map_cutoff=map_cutoff, use_pbc=False),
            meta=ContactMeta(sel1="p", sel2="l"))

    @staticmethod
    def _batches(nframes=40, bsize=5, seed=3):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0, 30, (nframes, 10, 3)).astype(np.float32)
        ids = np.arange(nframes)
        return [FrameBatch(ids[i:i + bsize], ids[i:i + bsize] * 0.1,
                           pos[i:i + bsize])
                for i in range(0, nframes, bsize)]

    @staticmethod
    def _interrupt_after(batches, n):
        for i, b in enumerate(batches):
            if i == n:
                raise RuntimeError("preempted")
            yield b

    @staticmethod
    def _assert_same(a, b):
        assert np.array_equal(a.frames, b.frames)
        assert np.array_equal(a.sel1_resids, b.sel1_resids)
        assert np.array_equal(a.sel2_resids, b.sel2_resids)
        assert np.array_equal(a.min_dist, b.min_dist)
        assert np.array_equal(a.times, b.times)
        assert a.meta.ts == pytest.approx(b.meta.ts)

    def test_resume_is_exact(self, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        batches = self._batches()
        full = self._mapper().run(batches)
        with pytest.raises(RuntimeError, match="preempted"):
            self._mapper().run(self._interrupt_after(batches, 5),
                               checkpoint_dir=ck, checkpoint_every=5)
        assert os.path.exists(os.path.join(ck, "state.json"))
        import json as _json
        with open(os.path.join(ck, "state.json")) as fh:
            state = _json.load(fh)
        assert 0 < state["next_frame"] < 40
        assert state["shards"] >= 1
        resumed = self._mapper().run(batches, checkpoint_dir=ck,
                                     checkpoint_every=5)
        self._assert_same(resumed, full)
        # the directory survives run() — records are only in memory until
        # the caller saves them; a rerun before removal is idempotent
        assert os.path.exists(os.path.join(ck, "state.json"))
        again = self._mapper().run(batches, checkpoint_dir=ck,
                                   checkpoint_every=5)
        self._assert_same(again, full)
        MapContacts.remove_checkpoint(ck)
        assert not os.path.exists(ck)

    def test_resume_with_different_batching_straddles(self, tmp_path):
        """Checkpoints align to the interrupted run's batch ends; a resume
        with a different batch size lands mid-batch and must drop the
        already-covered head rows."""
        ck = str(tmp_path / "scan.ckpt")
        full = self._mapper().run(self._batches())
        with pytest.raises(RuntimeError):
            self._mapper().run(
                self._interrupt_after(self._batches(), 4),
                checkpoint_dir=ck, checkpoint_every=1)
        resumed = self._mapper().run(self._batches(bsize=4),
                                     checkpoint_dir=ck, checkpoint_every=7)
        self._assert_same(resumed, full)

    def test_fingerprint_mismatch_is_refused(self, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        with pytest.raises(RuntimeError):
            self._mapper().run(self._interrupt_after(self._batches(), 3),
                               checkpoint_dir=ck, checkpoint_every=1)
        with pytest.raises(ValueError, match="different selections"):
            self._mapper(map_cutoff=9.0).run(self._batches(),
                                             checkpoint_dir=ck)

    def test_fresh_run_with_checkpointing_matches_plain(self, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        batches = self._batches(nframes=20, bsize=6)   # trailing partial
        full = self._mapper().run(batches)
        ckd = self._mapper().run(batches, checkpoint_dir=ck,
                                 checkpoint_every=6)
        self._assert_same(ckd, full)
        MapContacts.remove_checkpoint(ck)
        assert not os.path.exists(ck)

    def test_different_dt_is_refused(self, tmp_path):
        """--dt participates in the fingerprint: resuming a time-less-
        format scan with a different frame interval would mix times."""
        ck = str(tmp_path / "scan.ckpt")

        def mapper(dt):
            m = self._mapper()
            m.meta = ContactMeta(sel1="p", sel2="l", ts=dt)
            return m

        with pytest.raises(RuntimeError):
            mapper(0.1).run(self._interrupt_after(self._batches(), 3),
                            checkpoint_dir=ck, checkpoint_every=1)
        with pytest.raises(ValueError, match="remove"):
            mapper(0.2).run(self._batches(), checkpoint_dir=ck)


class TestUploadLayout:
    """Host-side residue-padded upload layout + u16 wire format."""

    @staticmethod
    def _scattered_system(rng, F=5):
        """Selections scattered through a frame with bystander atoms and
        RAGGED residues, so the host layout is non-identity and carries
        pad slots."""
        A = 60
        box = np.tile(np.array([22.0, 24.0, 26.0], np.float32), (F, 1))
        pos = (rng.uniform(0, 1, (F, A, 3)) * box[0]).astype(np.float32)
        # group 1: three residues of 2/3/1 atoms at scattered indices
        indices1 = np.array([3, 7, 11, 12, 20, 33])
        resids1 = np.array([1, 1, 2, 2, 2, 5])
        # group 2: two residues of 3/2 atoms, interleaved with bystanders
        indices2 = np.array([40, 41, 45, 50, 58])
        resids2 = np.array([9, 9, 9, 12, 12])
        return pos, box, indices1, resids1, indices2, resids2

    def _run(self, pos, box, i1, r1, i2, r2, **cfg_kw):
        F = pos.shape[0]
        mc = MapContacts(indices1=i1, resids1=r1, indices2=i2, resids2=r2,
                         cfg=ContactConfig(map_cutoff=10.0, **cfg_kw),
                         meta=ContactMeta(ts=0.1))
        assert not mc._layout_is_identity
        return mc.run([FrameBatch(np.arange(F), np.arange(F) * 0.1,
                                  pos, box=box)])

    def test_scattered_selections_match_bruteforce(self, rng=None):
        rng = np.random.default_rng(5)
        pos, box, i1, r1, i2, r2 = self._scattered_system(rng)
        rec = self._run(pos, box, i1, r1, i2, r2)
        # brute-force reference rows under the minimum image convention
        got = {(int(f), int(a), int(b)): float(d) for f, a, b, d in
               zip(rec.frames, rec.sel1_resids, rec.sel2_resids,
                   rec.min_dist)}
        n_expected = 0
        for f in range(pos.shape[0]):
            for ra in np.unique(r1):
                for rb in np.unique(r2):
                    p1 = pos[f, i1[r1 == ra]].astype(np.float64)
                    p2 = pos[f, i2[r2 == rb]].astype(np.float64)
                    d = p1[:, None, :] - p2[None, :, :]
                    d -= box[f] * np.round(d / box[f])
                    dmin = float(np.sqrt((d ** 2).sum(-1)).min())
                    if dmin <= 10.0:
                        n_expected += 1
                        assert got[(f, int(ra), int(rb))] == pytest.approx(
                            dmin, abs=1e-4)
        assert len(got) == n_expected > 0

    def test_u16_wire_format_matches_f32(self):
        """u16 rows must agree with f32 rows whenever no pair sits within
        the quantization tolerance of the cutoff; distances agree to the
        grid error bound (box/65535/2 per axis)."""
        rng = np.random.default_rng(17)
        pos, box, i1, r1, i2, r2 = self._scattered_system(rng)
        exact = self._run(pos, box, i1, r1, i2, r2)
        quant = self._run(pos, box, i1, r1, i2, r2, upload_dtype="u16")
        tol = float(np.sqrt(3) * box.max() / 65535.0)   # > worst case
        # no boundary ambiguity in this system -> identical row sets
        assert not np.any(np.abs(np.asarray(exact.min_dist) - 10.0) < tol)
        np.testing.assert_array_equal(quant.frames, exact.frames)
        np.testing.assert_array_equal(quant.sel1_resids, exact.sel1_resids)
        np.testing.assert_array_equal(quant.sel2_resids, exact.sel2_resids)
        np.testing.assert_allclose(quant.min_dist, exact.min_dist,
                                   atol=tol)

    def test_u16_unwrapped_coordinates(self):
        """Coordinates outside [0, box) wrap before quantization; the
        minimum-image distances are unchanged."""
        rng = np.random.default_rng(23)
        pos, box, i1, r1, i2, r2 = self._scattered_system(rng)
        shifted = pos + np.array([44.0, -48.0, 52.0], np.float32)  # 2 boxes
        a = self._run(pos, box, i1, r1, i2, r2, upload_dtype="u16")
        b = self._run(shifted, box, i1, r1, i2, r2, upload_dtype="u16")
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_allclose(a.min_dist, b.min_dist, atol=2e-3)

    def test_u16_without_box_quantizes_within_bound(self):
        """The affine u16 grid needs no box: distances agree with f32 to
        the per-axis extent/65535 grid error."""
        rng = np.random.default_rng(29)
        pos, _, i1, r1, i2, r2 = self._scattered_system(rng)
        mc_kw = dict(indices1=i1, resids1=r1, indices2=i2, resids2=r2,
                     meta=ContactMeta(ts=0.1))
        F = pos.shape[0]
        batches = lambda: [FrameBatch(np.arange(F), np.arange(F) * 0.1,  # noqa: E731
                                      pos)]
        a = MapContacts(cfg=ContactConfig(use_pbc=False), **mc_kw).run(
            batches())
        b = MapContacts(cfg=ContactConfig(use_pbc=False,
                                          upload_dtype="u16"),
                        **mc_kw).run(batches())
        ext = (pos.max(axis=1) - pos.min(axis=1)).max()
        tol = float(np.sqrt(3) * ext / 65535.0)
        np.testing.assert_allclose(b.min_dist, a.min_dist, atol=tol)

    def test_u16_extremes_never_wrap(self):
        """The fused quantizer (x*inv + off, cast-truncated, no clip pass)
        must keep the exact per-frame min/max atoms on the grid: a cast
        wrap at either end (max -> 0 or a negative rounding -> 65535)
        would move an atom by the full axis extent and blow the distance
        by tens of angstroms. Exercised with negative coordinates and an
        axis whose extremes belong to the two selections."""
        i1 = np.array([0, 1])
        r1 = np.array([1, 1])
        i2 = np.array([2, 3])
        r2 = np.array([9, 9])
        # frame 1 shifts everything negative; extremes sit on sel1/sel2
        base = np.array([[[-61.5, 0.0, 0.0], [-59.0, 1.0, 1.0],
                          [-58.0, 2.0, 0.5], [4.25, 3.0, 1.5]]],
                        np.float32)
        pos = np.concatenate([base, base - 100.0])
        F = pos.shape[0]
        mc_kw = dict(indices1=i1, resids1=r1, indices2=i2, resids2=r2,
                     meta=ContactMeta(ts=0.1))
        batches = lambda: [FrameBatch(np.arange(F), np.arange(F) * 0.1,  # noqa: E731
                                      pos)]
        a = MapContacts(cfg=ContactConfig(use_pbc=False, map_cutoff=70.0),
                        **mc_kw).run(batches())
        b = MapContacts(cfg=ContactConfig(use_pbc=False, map_cutoff=70.0,
                                          upload_dtype="u16"),
                        **mc_kw).run(batches())
        assert len(b.frames) == len(a.frames) == F  # one pair-row per frame
        tol = float(np.sqrt(3) * (pos.max() - pos.min()) / 65535.0)
        np.testing.assert_allclose(b.min_dist, a.min_dist, atol=tol)

    def test_u16_far_from_origin_never_wraps(self):
        """Unwrapped/drifted trajectories put coordinates thousands of
        angstroms from the origin with a small axis extent — the regime
        where the retired fused absolute-coordinate quantizer
        (x*inv + (0.5 - lo*inv)) accumulates float32 rounding that
        scales with |lo|/extent, reaches 65536.0 pre-cast, and wraps the
        frame's max atom to grid 0 (a silent full-axis-extent position
        error). The shifted-domain quantizer's bound is independent of
        |lo|; this exercises lo ~ -10000 A with 1.5-15 A extents, plus
        the direct grid-endpoint property on the raw helper."""
        from basicrta_tpu.contacts.quantize import quantize_u16
        rng = np.random.default_rng(7)
        for lo0, ext in [(-10000.0, 1.5), (-9973.25, 15.0),
                         (10000.0, 4.0), (-65000.0, 2.0)]:
            raw = lo0 + rng.random((4, 64, 3), np.float32) * ext
            # pin exact per-axis extremes so the endpoints are exercised
            raw[:, 0, :] = lo0
            raw[:, 1, :] = lo0 + ext
            q, scale = quantize_u16(raw)
            assert q[:, 0, :].max() == 0          # min atom on grid 0
            assert q[:, 1, :].min() == 65535      # max atom on grid end
            deq = q * scale[:, :1] + scale[:, 1:]
            tol = ext / 65535.0 * 0.51 + 1e-3
            np.testing.assert_allclose(deq, raw, atol=tol)
        # end-to-end: distances through MapContacts survive the shift
        i1, r1 = np.array([0, 1]), np.array([1, 1])
        i2, r2 = np.array([2, 3]), np.array([9, 9])
        base = np.array([[[0.0, 0.0, 0.0], [2.5, 1.0, 1.0],
                          [3.5, 2.0, 0.5], [9.0, 3.0, 1.5]]], np.float32)
        pos = np.concatenate([base - 10000.0, base - 9973.25])
        F = pos.shape[0]
        mc_kw = dict(indices1=i1, resids1=r1, indices2=i2, resids2=r2,
                     meta=ContactMeta(ts=0.1))
        batches = lambda: [FrameBatch(np.arange(F), np.arange(F) * 0.1,  # noqa: E731
                                      pos)]
        a = MapContacts(cfg=ContactConfig(use_pbc=False, map_cutoff=70.0),
                        **mc_kw).run(batches())
        b = MapContacts(cfg=ContactConfig(use_pbc=False, map_cutoff=70.0,
                                          upload_dtype="u16"),
                        **mc_kw).run(batches())
        assert len(b.frames) == len(a.frames) == F
        tol = float(np.sqrt(3) * 9.0 / 65535.0) + 1e-3
        np.testing.assert_allclose(b.min_dist, a.min_dist, atol=tol)

    def test_u16_preserves_pruned_path_on_straddling_residues(self):
        """Residues straddling the periodic boundary must keep tight
        bounding spheres under u16 — the affine offset does not wrap, so
        the pruned kernel's per-frame plausible-pair counts match the f32
        path exactly (a wrap-based quantizer splits such residues and
        silently collapses pruning into the dense fallback)."""
        rng = np.random.default_rng(31)
        pos, box, i1, r1, i2, r2 = self._scattered_system(rng)
        # push one residue of each group across the upper x boundary
        pos[:, i1[r1 == 2], 0] += box[0, 0] - 1.0
        pos[:, i2[r2 == 12], 0] += box[0, 0] - 1.0
        f32 = self._run(pos, box, i1, r1, i2, r2, prefilter=True)
        u16 = self._run(pos, box, i1, r1, i2, r2, prefilter=True,
                        upload_dtype="u16")
        tol = float(np.sqrt(3) * box.max() / 65535.0)
        np.testing.assert_array_equal(u16.frames, f32.frames)
        np.testing.assert_array_equal(u16.sel1_resids, f32.sel1_resids)
        np.testing.assert_allclose(u16.min_dist, f32.min_dist, atol=tol)

        # the pruned kernel itself must see the same per-frame
        # plausible-pair counts in both wire formats (locality preserved;
        # a wrapped quantizer inflates u16's counts toward R1*R2)
        def peak_pairs(upload):
            mc = MapContacts(indices1=i1, resids1=r1, indices2=i2,
                             resids2=r2,
                             cfg=ContactConfig(map_cutoff=10.0,
                                               prefilter=True,
                                               upload_dtype=upload),
                             meta=ContactMeta(ts=0.1))
            batch = FrameBatch(np.arange(pos.shape[0]),
                               np.arange(pos.shape[0]) * 0.1, pos, box=box)
            rows = []
            orig = mc._jit_pass

            def spy(*a, **kw):
                out = orig(*a, **kw)
                if kw.get("mode") == "pruned":
                    rows.append(np.asarray(mc._unfuse(
                        out, pos.shape[0])[0]))
                return out

            mc._jit_pass = spy
            mc.run([batch])
            return rows[-1]

        np.testing.assert_array_equal(peak_pairs("u16"),
                                      peak_pairs("f32"))
