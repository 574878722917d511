"""Morton-ordered triangle clusters — the dense acceleration structure.

The reference accelerates with a median-split BVH over x-sorted triangles
(buildBVH, reference src/main.cpp:98-171, fed by the centroid sort in
flatten, src/simplify/flatten.cpp:78). Pointer-chasing trees map poorly
onto wide array hardware; the equivalent dense structure is:

* sort triangles by the Morton code of their centroid (a 3D space-filling
  curve — strictly better spatial locality than the reference's 1D x-sort),
* cut the sorted order into fixed clusters,
* store one AABB per cluster.

The sweep kernel's culled entry (kernels/sweep_gpu.py) boxes each of its
triangle tiles in this order and lets each ray group loop only over the
tiles its slab test keeps — the dense analogue of BVH traversal.

Everything here is jittable jnp, so clustering runs on-device inside the
render step and differentiates through nothing (it feeds the
stop_gradient'd search only).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import jax
import jax.numpy as jnp

from esctp1raytracer_tpu.accel.aabb import triangle_bounds
from esctp1raytracer_tpu.scene.types import TriangleBuffer

CLUSTER = 128

# Triangles whose AABB diagonal exceeds OVERSIZE_K x the scene median sort
# AFTER all normally-sized ones (but before invalid padding). Rationale: a
# huge triangle (ground plane, area light) whose centroid lands mid-Morton
# poisons its 128-cluster — the cluster AABB grows to span the floor and
# EVERY ray pays the whole block. Segregated, the few big triangles share
# one block (usually alongside the invalid padding) and the dense mesh
# clusters stay tight.
OVERSIZE_K = 8.0


def _expand_bits_10(x: jax.Array) -> jax.Array:
    """Spread 10 bits of x so there are two zeros between each (uint32)."""
    x = x.astype(jnp.uint32)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton_codes(points: jax.Array) -> jax.Array:
    """30-bit 3D Morton codes for points [N, 3] (normalized internally)."""
    lo = jnp.min(points, axis=0)
    hi = jnp.max(points, axis=0)
    scale = jnp.where(hi - lo > 1e-30, 1.0 / (hi - lo), 0.0)
    q = jnp.clip((points - lo) * scale, 0.0, 1.0)
    grid = jnp.minimum((q * 1024.0).astype(jnp.uint32), 1023)
    return (
        (_expand_bits_10(grid[:, 0]) << 2)
        | (_expand_bits_10(grid[:, 1]) << 1)
        | _expand_bits_10(grid[:, 2])
    )


@jax.tree_util.register_dataclass
@dataclass
class ClusteredTriangles:
    """Morton-sorted triangle view + cluster AABB table.

    `perm` maps sorted position -> original triangle index, so search
    results translate back with one gather. Padded (invalid) triangles
    sort to the end (code 0xFFFFFFFF) and their clusters collapse to
    never-hit boxes.
    """

    tris: TriangleBuffer  # sorted
    perm: jax.Array  # [N] int32, sorted -> original
    cluster_min: jax.Array  # [C, 3]
    cluster_max: jax.Array  # [C, 3]
    oversized: jax.Array  # [N] bool (sorted order): diag > OVERSIZE_K x median

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_min.shape[0])


def build_clusters(tris: TriangleBuffer) -> ClusteredTriangles:
    n = tris.capacity
    assert n % CLUSTER == 0, n
    centroid = (tris.v0 + tris.v1 + tris.v2) / 3.0
    codes = morton_codes(centroid)  # 30-bit: always < 2^30
    tmin, tmax = triangle_bounds(tris)
    diag2 = jnp.sum((tmax - tmin) ** 2, axis=1)
    # Masked median over VALID triangles only: sort with +inf fill and
    # index the middle of the valid prefix. A plain median with zero fill
    # would be dragged to 0 whenever padding exceeds ~50% of capacity
    # (e.g. 36 valid in a 512-capacity buffer), flagging every triangle
    # as oversized and defeating the segregation entirely.
    n_valid = jnp.sum(tris.valid)
    filled = jnp.sort(jnp.where(tris.valid, diag2, jnp.inf))
    med2 = filled[jnp.maximum(n_valid - 1, 0) // 2]
    oversized = diag2 > (OVERSIZE_K * OVERSIZE_K) * jnp.maximum(med2, 1e-30)
    # Sort key segments: [normal | oversized | invalid]; Morton order is
    # preserved within each segment (bit 30 flags oversized, < 0xFFFFFFFF).
    codes = jnp.where(oversized, codes + jnp.uint32(1 << 30), codes)
    codes = jnp.where(tris.valid, codes, jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(codes).astype(jnp.int32)
    sorted_tris = jax.tree.map(lambda a: jnp.take(a, perm, axis=0), tris)
    oversized_sorted = jnp.take(oversized & tris.valid, perm)

    bmin, bmax = triangle_bounds(sorted_tris)
    # Invalid triangles get inverted boxes so their clusters never hit.
    big = jnp.float32(1e30)
    bmin = jnp.where(sorted_tris.valid[:, None], bmin, big)
    bmax = jnp.where(sorted_tris.valid[:, None], bmax, -big)
    c = n // CLUSTER
    cluster_min = jnp.min(bmin.reshape(c, CLUSTER, 3), axis=1)
    cluster_max = jnp.max(bmax.reshape(c, CLUSTER, 3), axis=1)
    return ClusteredTriangles(
        tris=sorted_tris, perm=perm, cluster_min=cluster_min,
        cluster_max=cluster_max, oversized=oversized_sorted,
    )


def cluster_table(clustered: ClusteredTriangles) -> jax.Array:
    """[8, C] f32 table: rows = min xyz, max xyz, pad."""
    c = clustered.num_clusters
    rows = [
        clustered.cluster_min[:, 0], clustered.cluster_min[:, 1],
        clustered.cluster_min[:, 2],
        clustered.cluster_max[:, 0], clustered.cluster_max[:, 1],
        clustered.cluster_max[:, 2],
    ]
    table = jnp.stack(rows, axis=0)
    return jnp.concatenate([table, jnp.zeros((2, c), jnp.float32)], axis=0)
