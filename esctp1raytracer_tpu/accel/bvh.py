"""Median-split BVH over the flat triangle table.

Capability parity with the reference's BVH (bvh_node src/scene/bvh.h:10-21,
buildBVH src/main.cpp:98-171: recursive index-median split over x-sorted
triangles), built correctly:

* leaves own their actual [start, count) range — the reference's traversal
  re-scanned the ROOT's whole range at every leaf (quirk 3,
  src/main.cpp:337), making its BVH slower than brute force;
* the builder is iterative over a numpy array (no 2-threads-per-node
  unbounded fan-out, quirk 11) and produces flat arrays, not pointers.

On the device the production acceleration path is the Morton-sorted tile
culling of the sweep kernel (accel/clusters.py, kernels/cull.py) — trees
don't vectorize — so this BVH serves (a) the
component-parity surface, (b) host-side ray queries (`BVH.intersect`) used
for validation, and (c) the spatial-sort groundwork shared with clusters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from esctp1raytracer_tpu.scene.types import TriangleBuffer


@dataclass
class BVH:
    """Flat-array BVH. Node i: box [bmin[i], bmax[i]]; leaf iff
    left[i] < 0, owning sorted-triangle range [start[i], start[i]+count[i])."""

    bmin: np.ndarray  # [M, 3]
    bmax: np.ndarray  # [M, 3]
    left: np.ndarray  # [M] int32 (-1 for leaf)
    right: np.ndarray  # [M] int32
    start: np.ndarray  # [M] int32
    count: np.ndarray  # [M] int32
    order: np.ndarray  # [N] int32: sorted position -> original tri index
    verts: np.ndarray  # [N, 3, 3] sorted triangle vertices

    @property
    def num_nodes(self) -> int:
        return int(self.bmin.shape[0])

    def intersect(self, o, d, t_max: float = 1e30) -> Tuple[float, int]:
        """Host-side closest-hit via ordered traversal with early-out.

        Returns (t, original_tri_index) with index -1 on miss. Used for
        cross-checking device results, not on the device hot path.
        """
        from esctp1raytracer_tpu.core.intersect import EPS

        o = np.asarray(o, np.float32)
        d = np.asarray(d, np.float32)
        inv = np.where(np.abs(d) > 1e-30, 1.0 / d, np.float32(1e30))
        best_t, best_i = np.float32(t_max), -1
        stack = [0]
        while stack:
            node = stack.pop()
            t0 = (self.bmin[node] - o) * inv
            t1 = (self.bmax[node] - o) * inv
            tnear = np.maximum.reduce(np.minimum(t0, t1))
            tfar = np.minimum.reduce(np.maximum(t0, t1))
            if tnear > tfar or tfar < 0 or tnear > best_t:
                continue
            if self.left[node] < 0:
                s, c = self.start[node], self.count[node]
                for k in range(s, s + c):
                    v0, v1, v2 = self.verts[k]
                    e1, e2 = v1 - v0, v2 - v0
                    pvec = np.cross(d, e2)
                    det = np.dot(e1, pvec)
                    if abs(det) < EPS:
                        continue
                    invd = 1.0 / det
                    tvec = o - v0
                    u = np.dot(tvec, pvec) * invd
                    if u < EPS or u > 1.0:
                        continue
                    qvec = np.cross(tvec, e1)
                    v = np.dot(d, qvec) * invd
                    if v < EPS or u + v > 1.0:
                        continue
                    t = np.dot(e2, qvec) * invd
                    if EPS <= t < best_t:
                        best_t, best_i = t, int(self.order[k])
            else:
                stack.append(int(self.right[node]))
                stack.append(int(self.left[node]))
        return float(best_t), best_i


def build_bvh(tris: TriangleBuffer, leaf_size: int = 4,
              use_native: bool = True) -> BVH:
    """Build over the valid triangles only (padding excluded)."""
    valid = np.asarray(tris.valid)
    verts = np.stack(
        [np.asarray(tris.v0), np.asarray(tris.v1), np.asarray(tris.v2)], axis=1
    )[valid].astype(np.float32)
    orig_idx = np.nonzero(valid)[0].astype(np.int32)
    n = verts.shape[0]
    if n == 0:
        raise ValueError("cannot build BVH over an empty scene")

    if use_native:
        try:
            from esctp1raytracer_tpu.accel.native_bvh import build_bvh_native

            return build_bvh_native(verts, orig_idx, leaf_size)
        except Exception:  # fall back to the numpy builder
            pass

    tmin = verts.min(axis=1)
    tmax = verts.max(axis=1)
    centroid = verts.mean(axis=1)

    order = np.arange(n, dtype=np.int32)
    bmin_l, bmax_l, left_l, right_l, start_l, count_l = [], [], [], [], [], []

    def new_node():
        for lst, val in ((bmin_l, None), (bmax_l, None), (left_l, -1),
                         (right_l, -1), (start_l, 0), (count_l, 0)):
            lst.append(val)
        return len(left_l) - 1

    # Iterative build: stack of (node_id, begin, end).
    root = new_node()
    stack = [(root, 0, n)]
    while stack:
        node, begin, end = stack.pop()
        seg = order[begin:end]
        bmin_l[node] = tmin[seg].min(axis=0)
        bmax_l[node] = tmax[seg].max(axis=0)
        if end - begin <= leaf_size:
            left_l[node] = -1
            right_l[node] = -1
            start_l[node] = begin
            count_l[node] = end - begin
            continue
        # Median split along the widest centroid axis (the reference used
        # a global x-sort + index median; widest-axis is strictly better
        # and still deterministic).
        c = centroid[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        local = np.argsort(c[:, axis], kind="stable")
        order[begin:end] = seg[local]
        mid = begin + (end - begin) // 2
        li, ri = new_node(), new_node()
        left_l[node], right_l[node] = li, ri
        stack.append((ri, mid, end))
        stack.append((li, begin, mid))

    return BVH(
        bmin=np.asarray(bmin_l, np.float32),
        bmax=np.asarray(bmax_l, np.float32),
        left=np.asarray(left_l, np.int32),
        right=np.asarray(right_l, np.int32),
        start=np.asarray(start_l, np.int32),
        count=np.asarray(count_l, np.int32),
        order=orig_idx[order],
        verts=verts[order],
    )
