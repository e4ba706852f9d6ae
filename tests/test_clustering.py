"""KNN clustering oracle tests: synthetic blobs (SURVEY §4 suggested
per-module coverage)."""

import numpy as np

from polychordlite_tpu.core.clustering import do_clustering, nn_clustering
from polychordlite_tpu.core.rti import RunTimeInfo, find_min_loglikelihoods
from polychordlite_tpu.ops.linalg import similarity_matrix_np
from polychordlite_tpu.settings import PolyChordSettings


def blobs(centres, n_per, scale=0.02, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [c + scale * rng.standard_normal((n_per, len(c))) for c in centres]
    )
    labels = np.repeat(np.arange(len(centres)), n_per)
    return pts, labels


class TestNNClustering:
    def test_single_blob_is_one_cluster(self):
        pts, _ = blobs([np.array([0.5, 0.5])], 40)
        labels = nn_clustering(similarity_matrix_np(pts))
        assert labels.max() == 0

    def test_two_well_separated_blobs(self):
        pts, truth = blobs([np.array([0.2, 0.2]), np.array([0.8, 0.8])], 30)
        labels = nn_clustering(similarity_matrix_np(pts))
        assert labels.max() + 1 == 2
        # partition matches ground truth up to relabelling
        for t in (0, 1):
            assert len(np.unique(labels[truth == t])) == 1
        assert labels[truth == 0][0] != labels[truth == 1][0]

    def test_four_blobs(self):
        centres = [
            np.array([0.15, 0.15]),
            np.array([0.15, 0.85]),
            np.array([0.85, 0.15]),
            np.array([0.85, 0.85]),
        ]
        pts, truth = blobs(centres, 25, seed=3)
        labels = nn_clustering(similarity_matrix_np(pts))
        assert labels.max() + 1 == 4
        for t in range(4):
            assert len(np.unique(labels[truth == t])) == 1

    def test_tiny_input(self):
        assert nn_clustering(np.zeros((1, 1))).tolist() == [0]
        assert nn_clustering(np.zeros((2, 2))).tolist() == [0, 0]


class TestDoClustering:
    def _rti_with_blobs(self):
        s = PolyChordSettings(2, 0, nlive=60, num_repeats=4).finalise()
        rti = RunTimeInfo(s, 1)
        pts, truth = blobs([np.array([0.2, 0.2]), np.array([0.8, 0.8])], 30, seed=1)
        live = np.zeros((60, s.nTotal))
        live[:, s.h] = pts
        live[:, s.p] = pts
        live[:, s.l0] = -((pts - 0.5) ** 2).sum(1)
        rti.live[0] = live
        find_min_loglikelihoods(rti)
        return s, rti, truth

    def test_split_detected_and_bookkept(self):
        s, rti, truth = self._rti_with_blobs()
        assert do_clustering(rti)
        assert rti.ncluster == 2
        assert sorted(c.shape[0] for c in rti.live) == [30, 30]
        # volumes split in proportion, summing to the original
        from polychordlite_tpu.ops.logspace import logsumexp

        assert np.isclose(logsumexp(np, rti.logXp), 0.0)  # was log X = 0
        assert rti.epoch == 1  # reorganisation bumps the epoch

    def test_stable_after_split(self):
        s, rti, _ = self._rti_with_blobs()
        do_clustering(rti)
        # a second pass should find nothing new
        assert not do_clustering(rti)
        assert rti.ncluster == 2

    def test_sub_dimension_clustering(self):
        s, rti, _ = self._rti_with_blobs()
        # cluster on dimension 0 only: blobs still separate there (1-D data
        # may legitimately over-fragment — mutual-kNN chains — but no cluster
        # may ever span both blobs)
        assert do_clustering(rti, sub_dimensions=[0])
        assert rti.ncluster >= 2
        for c in rti.live:
            side = c[:, 0] > 0.5
            assert side.all() or (~side).all()


class TestReferenceOracleParity:
    """Partition-identity against a direct transliteration of the reference
    algorithm (tests/clustering_oracle.py; clustering.f90:15-188) — the
    production vectorised implementation must produce IDENTICAL
    partitions."""

    def _check(self, sim):
        from clustering_oracle import (
            nn_clustering as oracle,
            partition_key,
        )

        lab_o, num_o = oracle(sim.copy())
        lab_p = nn_clustering(sim.copy())
        assert partition_key(lab_o) == partition_key(lab_p), (
            f"oracle found {num_o} clusters, production "
            f"{lab_p.max() + 1}, partitions differ"
        )

    def test_synthetic_geometries(self):
        rng = np.random.default_rng(0)
        cases = []
        a = rng.normal([0.2, 0.2], 0.03, (40, 2))
        b = rng.normal([0.8, 0.8], 0.03, (40, 2))
        cases.append(np.vstack([a, b]))
        cases.append(rng.normal(0.5, 0.1, (60, 2)))  # single blob
        th = rng.uniform(0, 2 * np.pi, 50)
        s1 = np.c_[0.25 + 0.12 * np.cos(th), 0.5 + 0.12 * np.sin(th)]
        th2 = rng.uniform(0, 2 * np.pi, 50)
        s2 = np.c_[0.75 + 0.12 * np.cos(th2), 0.5 + 0.12 * np.sin(th2)]
        cases.append(
            np.vstack([s1, s2]) + rng.normal(0, 0.004, (100, 2))
        )  # thin shells
        cases.append(rng.uniform(0, 1, (80, 3)))  # ambiguous scatter
        t = rng.uniform(0, 1, 60)
        cases.append(np.c_[t, 0.5 + 0.01 * rng.normal(size=60)])  # filament
        for data in cases:
            self._check(similarity_matrix_np(data))

    def test_live_point_snapshots(self):
        """Saved live-point snapshots from real gaussian_shells / eggbox
        runs (tests/data/clustering_snapshot_*.npy)."""
        import glob
        import os

        paths = sorted(
            glob.glob(
                os.path.join(
                    os.path.dirname(__file__),
                    "data",
                    "clustering_snapshot_*.npy",
                )
            )
        )
        assert len(paths) >= 4, "snapshot files missing"
        for p in paths:
            self._check(np.load(p))

    def test_random_stress(self):
        """Random mixtures with varying separation/size — the regime where
        tie-breaking and iteration-order bugs would show up."""
        for seed in range(12):
            rng = np.random.default_rng(100 + seed)
            ncl = rng.integers(1, 5)
            pts = np.vstack(
                [
                    rng.normal(
                        rng.uniform(0, 1, 2),
                        rng.uniform(0.02, 0.12),
                        (int(rng.integers(8, 30)), 2),
                    )
                    for _ in range(ncl)
                ]
            )
            self._check(similarity_matrix_np(pts))
