"""Test-only oracle: direct transliteration of the reference KNN clustering.

A deliberately line-for-line (non-vectorised) port of
``/root/reference/src/polychord/clustering.f90`` (``NN_clustering`` :15-97,
``do_clustering_k`` :100-130, ``compute_knn`` :134-174, ``neighbours``
:178-188) and ``relabel`` (``utils.F90:713-752``), used ONLY to ground-truth
the production ``polychordlite_tpu/core/clustering.py``.

Fidelity notes:

* ``compute_knn`` keeps the reference's insertion order: neighbours sorted
  by squared distance, ties broken by smaller point index (the eoshift
  insertion inserts after equal entries).
* ``neighbours`` uses ``knn2[0]`` (the first neighbour), NOT "the point
  itself" — these differ only for exactly-duplicate points.
* The Fortran loop ``do n=2,k`` fixes its trip count AT ENTRY (F90
  semantics): the in-loop ``k=min(k*2,nlive)`` expansion can never extend
  the sweep, so the effective maximum neighbour count is ``min(nlive, 10)``.
  The transliteration reproduces this exactly (``k_entry``).
* The recursion relabels after every sub-split and only advances
  ``i_cluster`` when a sub-clustering returns a single cluster, exactly as
  the reference while-loop does.
"""

from __future__ import annotations

import numpy as np


def relabel(array):
    """utils.F90:713-752 — relabel with 1,2,3,... in order of first
    appearance.  Returns (relabelled, num_labels)."""
    array = np.asarray(array)
    mapping = []
    for x in array:
        if x not in mapping:
            mapping.append(x)
    out = np.empty_like(array)
    for i_label, lab in enumerate(mapping):
        out[array == lab] = i_label + 1
    return out, len(mapping)


def compute_knn(sim, k):
    """clustering.f90:134-174 — insertion-sorted k nearest neighbours per
    point (self included at distance 0).  Returns (n, k) of 0-based
    indices (the reference is 1-based; only relative identity matters)."""
    n = sim.shape[0]
    knn = np.zeros((n, k), dtype=int)
    for i in range(n):
        dist = np.full(k, np.inf)
        row = np.full(k, -1, dtype=int)
        for j in range(n):
            # minloc(distance2s, mask=distance2s > sim(i,j)): dist is kept
            # ascending, so the minimum masked entry is the first > sim[i,j]
            cand = np.nonzero(dist > sim[i, j])[0]
            if cand.size:
                p = cand[0]
                dist[p + 1 :] = dist[p:-1]
                dist[p] = sim[i, j]
                row[p + 1 :] = row[p:-1]
                row[p] = j
        knn[i] = row
    return knn


def neighbours(knn1, knn2):
    """clustering.f90:178-188."""
    return bool(np.any(knn1 == knn2[0]) or np.any(knn2 == knn1[0]))


def do_clustering_k(knn):
    """clustering.f90:100-130 — pairwise sweep with whole-cluster merge to
    the smaller label.  ``knn`` is (n, n_neighbours); returns 1-based raw
    labels (the min merged index + 1)."""
    n = knn.shape[0]
    c = np.arange(1, n + 1)
    for i in range(n):
        for j in range(i + 1, n):
            if c[i] != c[j] and neighbours(knn[i], knn[j]):
                lo = min(c[i], c[j])
                c[(c == c[i]) | (c == c[j])] = lo
    return c


def nn_clustering(sim):
    """clustering.f90:15-97 — recursive NN clustering of a similarity
    matrix.  Returns (1-based labels, num_clusters)."""
    nlive = sim.shape[0]
    k = min(nlive, 10)
    knn = compute_knn(sim, k)
    cluster_list_old = np.arange(1, nlive + 1)
    cluster_list = None
    num_clusters = nlive

    k_entry = k  # Fortran do-loop trip count is fixed at entry
    for n in range(2, k_entry + 1):
        cluster_list, num_clusters = relabel(do_clustering_k(knn[:, :n]))
        assert num_clusters > 0
        if num_clusters == 1:
            return cluster_list, num_clusters
        if np.array_equal(cluster_list, cluster_list_old):
            break
        if n == k:
            # reference expands knn here; with the fixed trip count the
            # wider list is never consulted, but reproduce the state change
            k = min(k * 2, nlive)
            knn_new = compute_knn(sim, k)
            knn = knn_new
        cluster_list_old = cluster_list

    if cluster_list is None:  # nlive < 2: loop body never ran
        return np.ones(nlive, dtype=int), 1

    if num_clusters > 1:
        i_cluster = 1
        while i_cluster <= num_clusters:
            points = np.nonzero(cluster_list == i_cluster)[0]
            sub, num_new = nn_clustering(sim[np.ix_(points, points)])
            cluster_list[points] = num_clusters + sub
            if num_new == 1:
                i_cluster += 1
            cluster_list, num_clusters = relabel(cluster_list)

    return cluster_list, num_clusters


def similarity_matrix(data):
    """calculate.f90:94-109 Gram-trick pairwise squared distances."""
    g = data @ data.T
    d = np.diag(g)
    return d[:, None] + d[None, :] - 2 * g


def partition_key(labels):
    """Canonical form of a partition for label-agnostic comparison."""
    labels = np.asarray(labels)
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(lab, []).append(i)
    return frozenset(frozenset(g) for g in groups.values())
