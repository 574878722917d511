"""Closest-hit and any-hit triangle sweep: one Pallas kernel, Triton route.

The O(rays x triangles) search is the renderer's hot path. XLA's form of
it (`core/intersect.py:_scan_blocks`) writes `[R, block]` temporaries to
device memory for every triangle block. This kernel keeps each ray
block's running answer in registers and streams only the rays and a
12-float-per-triangle constant table (which sits in L2: 131k triangles
are ~6.3 MB).

One program owns RAY_BLOCK rays and loops over tiles of TRI_TILE
triangles. Each step evaluates every (ray, triangle) pair of the tile as
one `[RAY_BLOCK, TRI_TILE]` elementwise block:

* closest hit keeps a running `(t, tile)` per pair slot with strict `<`,
  so a slot keeps its earliest tile on ties; one fold at the end takes
  the minimum t and, among equal t, the lowest triangle index. That is
  the reference's first-wins rule (`t2 >= t -> reject`,
  src/scene/ray_triangle.h:48), the same winner as `_scan_blocks`;
* any hit folds an OR under the `t_limit` ceiling and leaves the loop
  once every ray of the block is occluded.

The pair test is the plane + barycentric form (`tri_constants`) of the
reference's Moller-Trumbore acceptance window, in float32 with no matrix
product. It rounds differently from `mt_intersect` at the eps edges
(quirk 16), so a few borderline rays pick another winner.

The culled entry sorts the table into Morton order (`accel/clusters.py`),
slab-tests each program's ray group against every tile's box in XLA
(`kernels/cull.py`), and hands each program its ascending list of kept
tiles and their count as the loop bound. Ties then resolve in sorted
order.

The kernel compiles only for a GPU. On another platform the caller must
ask for the Pallas interpreter explicitly (`interpret=True`), which only
tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from esctp1raytracer_tpu.accel.clusters import CLUSTER, build_clusters
from esctp1raytracer_tpu.core.intersect import BIG, NO_HIT
from esctp1raytracer_tpu.kernels.cull import group_cull_mask
from esctp1raytracer_tpu.scene.types import TriangleBuffer

RAY_BLOCK = 64   # rays per program
TRI_TILE = 32    # triangles per loop step
NUM_WARPS = 4
NUM_STAGES = 1
NUM_CONSTANTS = 12  # n | v0 | w_u | w_v, three floats each
# Tables at least this large take the culled entry by default. On an
# H100 the pre-pass costs more than it saves on Cornell (512 slots:
# closest 1.57 vs 1.12 ms brute at 1024x768) and wins from the mixed
# scene up (1536 slots: 1.82 vs 6.35 ms at 1080p).
CULL_MIN_TRIS = 1024

_INT_MAX = np.int32(np.iinfo(np.int32).max)


def tri_constants(tris: TriangleBuffer) -> jax.Array:
    """Per-triangle plane + barycentric constants, [N, 12].

    Row: n = e1 x e2, v0, w_u = (e2 x n)/|n|^2 and w_v = (n x e1)/|n|^2,
    so that with s = o - v0 and det = -d.n: t = s.n / det, and for the
    hit offset q = s + t d, u = w_u.q and v = w_v.q. Working relative
    to v0 keeps the sums small where a scene sits far from the origin.
    Invalid triangles get a zero normal, so det == 0 rejects them with
    no per-pair valid test.
    """
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    nrm = jnp.cross(e1, e2)
    nrm = jnp.where(tris.valid[:, None], nrm, 0.0)
    nn = jnp.sum(nrm * nrm, axis=-1, keepdims=True)
    nn = jnp.where(nn > 0, nn, 1.0)
    w_u = jnp.cross(e2, nrm) / nn
    w_v = jnp.cross(nrm, e1) / nn
    return jnp.concatenate([nrm, tris.v0, w_u, w_v], axis=1)


def _tile_table(consts: jax.Array) -> jax.Array:
    """[N, 12] -> [NT, 12, TRI_TILE], zero-padded (zero rows never hit)."""
    n = consts.shape[0]
    nt = max(1, -(-n // TRI_TILE))
    pad = nt * TRI_TILE - n
    if pad:
        consts = jnp.concatenate(
            [consts, jnp.zeros((pad, NUM_CONSTANTS), consts.dtype)])
    return consts.reshape(nt, TRI_TILE, NUM_CONSTANTS).transpose(0, 2, 1)


def _pair_test(ray, tc_ref, k, eps):
    """t and acceptance of every (ray, triangle) pair of tile k:
    [RAY_BLOCK, TRI_TILE] each."""
    ox, oy, oz, dx, dy, dz = ray

    def row(r):
        return tc_ref[k, r, :][None, :]

    nx, ny, nz = row(0), row(1), row(2)
    sx, sy, sz = ox - row(3), oy - row(4), oz - row(5)
    det = -(dx * nx + dy * ny + dz * nz)
    t = (sx * nx + sy * ny + sz * nz) / det
    qx = sx + t * dx
    qy = sy + t * dy
    qz = sz + t * dz
    u = row(6) * qx + row(7) * qy + row(8) * qz
    v = row(9) * qx + row(10) * qy + row(11) * qz
    # u <= 1 follows from v >= eps and u + v <= 1. A NaN t (det == 0)
    # fails every compare.
    ok = ((jnp.abs(det) >= eps) & (jnp.minimum(u, v) >= eps)
          & (u + v <= 1.0) & (t >= eps))
    return t, ok


def _load_rays(rays_ref, rows):
    return [rays_ref[c, :][:, None] for c in range(rows)]


def _closest_kernel(eps_ref, rays_ref, tc_ref, *refs, culled: bool):
    if culled:
        ids_ref, cnt_ref, t_ref, idx_ref = refs
        n = cnt_ref[0]
    else:
        t_ref, idx_ref = refs
        n = tc_ref.shape[0]
    eps = eps_ref[0]
    ray = _load_rays(rays_ref, 6)
    shape = (RAY_BLOCK, TRI_TILE)

    def body(k, carry):
        bt, bk = carry
        jb = ids_ref[k] if culled else k
        t, ok = _pair_test(ray, tc_ref, jb, eps)
        better = ok & (t < bt)
        return jnp.where(better, t, bt), jnp.where(better, jb, bk)

    init = (jnp.full(shape, BIG, jnp.float32),
            jnp.full(shape, NO_HIT, jnp.int32))
    bt, bk = jax.lax.fori_loop(0, n, body, init)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    gi = jnp.where(bk >= 0, bk * TRI_TILE + lane, _INT_MAX)
    tmin = jnp.min(bt, axis=1)
    imin = jnp.min(jnp.where(bt == tmin[:, None], gi, _INT_MAX), axis=1)
    t_ref[...] = tmin
    idx_ref[...] = jnp.where(tmin < BIG, imin, NO_HIT)


def _any_kernel(eps_ref, rays_ref, tc_ref, *refs, culled: bool):
    if culled:
        ids_ref, cnt_ref, occ_ref = refs
        n = cnt_ref[0]
    else:
        (occ_ref,) = refs
        n = tc_ref.shape[0]
    eps = eps_ref[0]
    ray = _load_rays(rays_ref, 6)
    tlim = rays_ref[6, :]
    # A ray whose ceiling is at or below eps can never be occluded; it
    # must not hold the block in the loop.
    never = (tlim <= eps).astype(jnp.int32)

    def cond(state):
        k, occ = state
        return (k < n) & (jnp.min(jnp.maximum(occ, never)) == 0)

    def body(state):
        k, occ = state
        jb = ids_ref[k] if culled else k
        t, ok = _pair_test(ray, tc_ref, jb, eps)
        hit = (ok & (t < tlim[:, None])).astype(jnp.int32)
        return k + 1, jnp.maximum(occ, jnp.max(hit, axis=1))

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((RAY_BLOCK,), jnp.int32)))
    occ_ref[...] = occ


def _ray_rows(o, d, t_limit):
    """[8, Rp] ray table (o, d, t_limit, 0), padded to RAY_BLOCK.

    Padding rays point down +z from the origin with a negative ceiling:
    they never count as occluded and their outputs are sliced off.
    """
    r = o.shape[0]
    pad = (-r) % RAY_BLOCK
    if t_limit is None:
        t_limit = jnp.full((r,), BIG, jnp.float32)
    rows = jnp.concatenate(
        [o.T, d.T, t_limit[None].astype(jnp.float32),
         jnp.zeros((1, r), jnp.float32)], axis=0)
    if pad or r == 0:
        pad = pad or RAY_BLOCK
        filler = jnp.zeros((8, pad), jnp.float32)
        filler = filler.at[5].set(1.0).at[6].set(-1.0)
        rows = jnp.concatenate([rows, filler], axis=1)
    return rows


def _launch(kernel, name, out_dtypes, eps, rays, tc, lists, interpret):
    programs = rays.shape[1] // RAY_BLOCK
    in_specs = [
        pl.BlockSpec((1,), lambda i: (0,)),
        pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
        pl.BlockSpec(tc.shape, lambda i: (0, 0, 0)),
    ]
    args = [jnp.asarray(eps, jnp.float32).reshape(1), rays, tc]
    if lists is not None:
        ids, cnt = lists
        in_specs += [pl.BlockSpec((None, ids.shape[1]), lambda i: (i, 0)),
                     pl.BlockSpec((1,), lambda i: (i,))]
        args += [ids, cnt]
    return pl.pallas_call(
        partial(kernel, culled=lists is not None),
        grid=(programs,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
                   for _ in out_dtypes],
        out_shape=[jax.ShapeDtypeStruct((rays.shape[1],), dt)
                   for dt in out_dtypes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name=name,
    )(*args)


def _sorted_tiles(tris: TriangleBuffer):
    """Morton-sorted tile table, per-tile boxes [8, NT] and sorted ->
    original index map (padding maps to NO_HIT)."""
    pad = (-tris.capacity) % CLUSTER
    if pad:
        tris = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), tris,
                            TriangleBuffer.empty(pad))
    clustered = build_clusters(tris)
    st = clustered.tris
    tc = _tile_table(tri_constants(st))
    nt = tc.shape[0]
    v = jnp.stack([st.v0, st.v1, st.v2], axis=1)
    big = jnp.float32(1e30)
    bmin = jnp.where(st.valid[:, None], jnp.min(v, axis=1), big)
    bmax = jnp.where(st.valid[:, None], jnp.max(v, axis=1), -big)
    bmin = jnp.min(bmin.reshape(nt, -1, 3), axis=1)
    bmax = jnp.max(bmax.reshape(nt, -1, 3), axis=1)
    aabbs = jnp.concatenate(
        [bmin.T, bmax.T, jnp.zeros((2, nt), jnp.float32)], axis=0)
    perm = jnp.where(st.valid, clustered.perm, NO_HIT)
    return tc, aabbs, perm


def _cull_lists(rays, aabbs):
    """Each program's ascending list of kept tiles [P, NT] and count [P].

    Padding rays (negative ceiling) add no ceiling of their own but do
    widen their group's slab hull: conservative, never wrong.
    """
    o, d, tl = rays[0:3].T, rays[3:6].T, rays[6]
    keep = group_cull_mask(o, d, aabbs, tl, group=RAY_BLOCK)
    ids = jnp.argsort(~keep, axis=1, stable=True).astype(jnp.int32)
    return ids, jnp.sum(keep, axis=1).astype(jnp.int32)


def _closest(o, d, tris, eps, t_limit, culled, interpret):
    r = o.shape[0]
    if culled:
        tc, aabbs, perm = _sorted_tiles(tris)
        rays = _ray_rows(o, d, t_limit)
        lists = _cull_lists(rays, aabbs)
    else:
        tc, lists = _tile_table(tri_constants(tris)), None
        rays = _ray_rows(o, d, None)
    t, idx = _launch(_closest_kernel, "sweep_closest",
                     (jnp.float32, jnp.int32), eps, rays, tc, lists,
                     interpret)
    t, idx = t[:r], idx[:r]
    if culled:
        idx = jnp.where(idx >= 0, jnp.take(perm, jnp.maximum(idx, 0)),
                        NO_HIT)
    return t, idx


def _occluded(o, d, t_limit, tris, eps, culled, interpret):
    r = o.shape[0]
    rays = _ray_rows(o, d, t_limit)
    if culled:
        tc, aabbs, _ = _sorted_tiles(tris)
        lists = _cull_lists(rays, aabbs)
    else:
        tc, lists = _tile_table(tri_constants(tris)), None
    (occ,) = _launch(_any_kernel, "sweep_any", (jnp.int32,), eps, rays, tc,
                     lists, interpret)
    return occ[:r] > 0


@dataclass(frozen=True)
class SweepSearch:
    """The `tri_search` hook of core/intersect.py, backed by the kernel.

    `culled` picks the Morton-sorted entry with per-program tile lists
    (True) or the brute sweep (False); None decides by table size
    (CULL_MIN_TRIS). `interpret` runs the Pallas interpreter instead of
    compiling for the GPU; it must be asked for, never inferred from the
    platform.
    """

    culled: Optional[bool] = None
    interpret: bool = False

    def _culled(self, tris: TriangleBuffer) -> bool:
        if self.culled is None:
            return tris.capacity >= CULL_MIN_TRIS
        return self.culled

    def __call__(self, o, d, tris: TriangleBuffer, eps, t_limit=None):
        """(best_t [R], triangle index [R] or -1). `t_limit` is a cull
        ceiling only; the brute entry ignores it."""
        return _closest(o, d, tris, eps, t_limit, self._culled(tris),
                        self.interpret)

    def occlusion(self, o, d, t_limit, tris: TriangleBuffer, eps):
        """[R] bool: some triangle is hit at eps <= t < t_limit."""
        return _occluded(o, d, t_limit, tris, eps, self._culled(tris),
                         self.interpret)
