"""Host-side algorithm utilities: the port's own copy of
``mloam_tpu/utils/algos.py`` (numpy, equal on the same inputs).

Counterparts of the reference's ``mloam_common`` algo extras (SURVEY §2.4):
convex hull (``common/algos/convex_hull.hpp``), Hungarian bigraph matcher
(``common/algos/hungarian_bigraph_matcher.{h,cpp}``) and undirected graph
with connected components (``common/algos/graph.hpp``). These serve the
object-level perception helpers around the SLAM core, not the per-sweep hot
path — plain NumPy on host is the right tool (no device round trips for
tiny irregular problems).
"""

from __future__ import annotations

import numpy as np


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Convex hull of 2-D points (Andrew's monotone chain, O(n log n)).

    Returns hull vertices in counter-clockwise order, [H, 2]. Degenerate
    inputs (<3 unique points, collinear sets) return the unique extreme
    points.
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # sorted by (x, y) from np.unique
    def cross(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(seq):
        out: list[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and cross(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    return hull


def polygon_area(hull: np.ndarray) -> float:
    """Signed shoelace area of an ordered polygon (CCW positive)."""
    x, y = hull[:, 0], hull[:, 1]
    return float(0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def hungarian(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment on a rectangular cost matrix (Jonker-style
    augmenting-path O(n³) Hungarian). Returns (row_idx, col_idx) pairs of
    the optimal assignment of min(n_rows, n_cols) size.

    Counterpart of the reference's HungarianOptimizer (used by the
    object-level bigraph matcher).
    """
    cost = np.asarray(cost, dtype=np.float64)
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    n, m = cost.shape  # n <= m
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.full(m + 1, n, dtype=np.int64)   # p[j] = row matched to col j
    way = np.zeros(m + 1, dtype=np.int64)
    for i in range(n):
        p[m] = i
        j0 = m
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], INF, -1
            cur = cost[i0, :] - u[i0] - v[:m]
            upd = ~used[:m] & (cur < minv[:m])
            minv[:m][upd] = cur[upd]
            way[:m][upd] = j0
            free = ~used[:m]
            if np.any(free):
                j1 = int(np.argmin(np.where(free, minv[:m], INF)))
                delta = minv[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == n:
                break
        while j0 != m:
            p[j0] = p[way[j0]]
            j0 = way[j0]
    rows = p[:m]
    cols = np.arange(m)
    keep = rows < n
    rows, cols = rows[keep], cols[keep]
    order = np.argsort(rows)
    rows, cols = rows[order], cols[order]
    if transposed:
        rows, cols = cols, rows
        order = np.argsort(rows)
        rows, cols = rows[order], cols[order]
    return rows, cols


class UndirectedGraph:
    """Small undirected graph with connected components (counterpart of the
    reference's ``common::Graph`` used for cluster merging)."""

    def __init__(self, n_vertices: int):
        self.n = n_vertices
        self.parent = np.arange(n_vertices)

    def _find(self, a: int) -> int:
        root = a
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[a] != root:  # path compression
            self.parent[a], a = root, self.parent[a]
        return root

    def add_edge(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)

    def components(self) -> list[list[int]]:
        roots = np.array([self._find(i) for i in range(self.n)])
        comps: dict[int, list[int]] = {}
        for i, r in enumerate(roots):
            comps.setdefault(int(r), []).append(i)
        return [comps[r] for r in sorted(comps)]
