"""Primitive intersection: Möller–Trumbore triangles + analytic spheres.

The triangle test reproduces the reference's "original jgt code"
(`tracer::intersect_triangle`, reference src/scene/ray_triangle.h:7-57)
with its exact acceptance window — det outside (-eps, eps), u in [eps, 1],
v >= eps, u+v <= 1, t in [eps, t_prev) (the thin eps miss band along two
edges is quirk 16 in SURVEY.md and is reproduced deliberately) — but
restructured for wide array hardware:

* early returns become masks (the ISPC branch-inward restructuring,
  src/ispc/trace.ispc:31-67, taken to its logical end: no branches at all);
* the closest-hit min-reduction (the `t2 >= t -> reject` in/out contract of
  the reference) becomes a blockwise masked argmin streamed over the padded
  primitive table — the reference's ISPC `foreach` over triangles
  (src/ispc/trace.ispc:70-84) as a `lax.scan` carrying the running best;
* the scan is wrapped in stop_gradient; gradients come from an O(rays)
  differentiable *recompute* of the winning primitive's t/u/v after a
  gather (`closest_hit`), so the backward pass never touches the O(rays ×
  primitives) search;
* an alternative formulation (the "mxu" backend) expresses det and the
  t/u/v numerators as one float32 [rays, 16] @ [16, 4*tris] contraction of
  ray moments against per-triangle trilinear coefficient columns
  (`ray_features` / `tri_features`).

Spheres are a new primitive family (the reference has none; required by
BASELINE.json) and are differentiable w.r.t. center and radius.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from esctp1raytracer_tpu.scene.types import Scene, SphereBuffer, TriangleBuffer

# float32 machine epsilon — the reference's std::numeric_limits<float>::epsilon()
# (src/scene/ray_triangle.h:23-47). The ISPC backend used 1e-4
# (src/ispc/ispc_helpers.h:5); we standardize on the C++ value.
EPS = np.float32(np.finfo(np.float32).eps)
T_MAX = np.float32(np.finfo(np.float32).max)
BIG = np.float32(1e30)  # miss sentinel, as the reference's new_hit_info t=1e30


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def _cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


# --------------------------------------------------------------------------
# Direct (broadcast) Möller–Trumbore
# --------------------------------------------------------------------------

def mt_intersect(
    o: jax.Array,
    d: jax.Array,
    v0: jax.Array,
    v1: jax.Array,
    v2: jax.Array,
    eps: jax.Array = EPS,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Möller–Trumbore with mask semantics.

    All inputs broadcast: o, d [..., 3] against v0/v1/v2 [..., 3].
    Returns (t, u, v, ok) where ok encodes the reference's acceptance
    window *except* the closest-hit comparison (t < t_prev), which the
    caller applies. Misses get t = BIG.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok_det = jnp.abs(det) >= eps
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = (
        ok_det
        & (u >= eps)
        & (u <= 1.0)
        & (v >= eps)
        & (u + v <= 1.0)
        & (t >= eps)
    )
    t = jnp.where(ok, t, BIG)
    return t, u, v, ok


def sphere_intersect(
    o: jax.Array,
    d: jax.Array,
    center: jax.Array,
    radius: jax.Array,
    eps: jax.Array = EPS,
) -> Tuple[jax.Array, jax.Array]:
    """Analytic ray-sphere hit (d must be normalized).

    Broadcasts o, d [..., 3] against center [..., 3] / radius [...].
    Returns (t, ok); t = BIG on miss. Nearest root >= eps wins.
    """
    oc = o - center
    b = _dot(oc, d)
    c0 = _dot(oc, oc) - radius * radius
    disc = b * b - c0
    ok_disc = disc >= 0.0
    # Double-where with a STRICT guard keeps sqrt' finite: sqrt'(0) = inf
    # (exact tangency, or the degenerate padded radius-0 spheres) would
    # otherwise turn a zero cotangent into 0 * inf = NaN through the where.
    pos = disc > 0.0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    t_near = -b - sq
    t_far = -b + sq
    t = jnp.where(t_near >= eps, t_near, t_far)
    ok = ok_disc & (t >= eps)
    t = jnp.where(ok, t, BIG)
    return t, ok


# --------------------------------------------------------------------------
# Feature formulation: intersection numerators as one contraction
# --------------------------------------------------------------------------
#
# With n = e1 x e2 (unnormalized geometric normal), Möller–Trumbore's four
# quantities are trilinear forms in (o, d, triangle):
#     det    = -d . n
#     t*det  =  o . n - v0 . n
#     u*det  =  det3(o - v0, d, e2)   (expansion in o_i d_j and d_j terms)
#     v*det  =  det3(d, o - v0, e1)
# so [det, t*det, u*det, v*det] = ray_features[16] @ tri_features[16, 4]:
# a K=16 contraction. Verified against
# mt_intersect in tests/test_intersect.py.

NUM_FEATURES = 16


def ray_features(o: jax.Array, d: jax.Array) -> jax.Array:
    """[..., 3] origin/direction -> [..., 16] moment features [d, o, o⊗d, 1]."""
    od = o[..., :, None] * d[..., None, :]  # o_i d_j, row-major (i, j)
    ones = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return jnp.concatenate(
        [d, o, od.reshape(*o.shape[:-1], 9), ones], axis=-1
    )


def _eps_cross_matrix(e: jax.Array) -> jax.Array:
    """C(e)_{ij} = sum_k eps_{ijk} e_k for e [..., 3] -> [..., 3, 3]."""
    zero = jnp.zeros_like(e[..., 0])
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    return jnp.stack(
        [
            jnp.stack([zero, ez, -ey], axis=-1),
            jnp.stack([-ez, zero, ex], axis=-1),
            jnp.stack([ey, -ex, zero], axis=-1),
        ],
        axis=-2,
    )


def tri_features(v0: jax.Array, v1: jax.Array, v2: jax.Array) -> jax.Array:
    """Per-triangle coefficient columns [..., 16, 4] for (det, t*det, u*det, v*det)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = _cross(e1, e2)
    zero3 = jnp.zeros_like(n)
    zero9 = jnp.zeros(n.shape[:-1] + (9,), n.dtype)
    zero1 = jnp.zeros(n.shape[:-1] + (1,), n.dtype)

    col_det = jnp.concatenate([-n, zero3, zero9, zero1], axis=-1)
    col_t = jnp.concatenate(
        [zero3, n, zero9, -_dot(v0, n)[..., None]], axis=-1
    )
    c_e2 = _eps_cross_matrix(e2).reshape(*n.shape[:-1], 9)
    col_u = jnp.concatenate(
        [_cross(v0, e2), zero3, c_e2, zero1], axis=-1
    )
    c_e1 = _eps_cross_matrix(e1).reshape(*n.shape[:-1], 9)
    col_v = jnp.concatenate(
        [-_cross(v0, e1), zero3, -c_e1, zero1], axis=-1
    )
    return jnp.stack([col_det, col_t, col_u, col_v], axis=-1)


def hits_from_features(
    rf: jax.Array, tf: jax.Array, eps: jax.Array = EPS
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Evaluate MT for all (ray, triangle) pairs as one contraction.

    rf: [R, 16] ray features; tf: [B, 16, 4] triangle features.
    Returns (t, u, v, ok) each [R, B]; t = BIG on miss.
    """
    # One contraction [R,16] @ [16, B*4], at Precision.HIGHEST (full
    # float32). Any lower precision (bf16x3, TF32) leaves a cancellation
    # error in t_num = o.n - v0.n (measured ~6e-5 relative) comparable to
    # the 1e-4 shadow-ray margin, and flipped ~6% of Cornell pixels'
    # occlusion tests. Revisit only with a wider shadow margin or a
    # separate any-hit formulation.
    tf_mat = jnp.swapaxes(tf, 0, 1).reshape(NUM_FEATURES, -1)  # [16, B*4]
    s = jnp.dot(rf, tf_mat, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)  # [R, B*4]
    s = s.reshape(rf.shape[0], tf.shape[0], 4)
    det, t_num, u_num, v_num = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    ok_det = jnp.abs(det) >= eps
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    t = t_num * inv_det
    u = u_num * inv_det
    v = v_num * inv_det
    ok = (
        ok_det & (u >= eps) & (u <= 1.0) & (v >= eps) & (u + v <= 1.0) & (t >= eps)
    )
    t = jnp.where(ok, t, BIG)
    return t, u, v, ok


# --------------------------------------------------------------------------
# Closest hit / any hit over the padded primitive table
# --------------------------------------------------------------------------

NO_HIT = np.int32(-1)

@jax.tree_util.register_dataclass
@dataclass
class HitRecord:
    """Per-ray hit info — the `ispc_hit_info` analogue
    (reference src/ispc/ispc_helpers.h:75-94) extended with primitive kind."""

    t: jax.Array  # [R] distance (BIG on miss)
    u: jax.Array  # [R] barycentric u (triangles only)
    v: jax.Array  # [R] barycentric v
    prim: jax.Array  # [R] int32 index into the tri/sphere buffer, -1 on miss
    is_sphere: jax.Array  # [R] bool
    hit: jax.Array  # [R] bool


def _scan_blocks(o, d, tris: TriangleBuffer, eps, block_size: int, use_mxu: bool):
    """Masked argmin of hit t over triangle blocks. Non-differentiable.

    Returns (best_t [R], best_idx [R] int32). Padded triangles are excluded
    via the valid mask (the t=BIG sentinel pattern of new_hit_info,
    reference src/ispc/ispc_helpers.h:87-94).
    """
    n = tris.capacity
    block_size = min(block_size, n)
    while n % block_size:  # capacity is padded; fall back to a divisor
        block_size //= 2
    num_blocks = n // block_size

    v0 = tris.v0.reshape(num_blocks, block_size, 3)
    v1 = tris.v1.reshape(num_blocks, block_size, 3)
    v2 = tris.v2.reshape(num_blocks, block_size, 3)
    valid = tris.valid.reshape(num_blocks, block_size)

    if use_mxu:
        rf = ray_features(o, d)

    def body(carry, blk):
        best_t, best_idx = carry
        bv0, bv1, bv2, bvalid, base = blk
        if use_mxu:
            tf = tri_features(bv0, bv1, bv2)
            t_blk, _, _, ok = hits_from_features(rf, tf, eps)
        else:
            t_blk, _, _, ok = mt_intersect(
                o[:, None, :], d[:, None, :],
                bv0[None, :, :], bv1[None, :, :], bv2[None, :, :], eps,
            )
        t_blk = jnp.where(ok & bvalid[None, :], t_blk, BIG)
        blk_min = jnp.min(t_blk, axis=1)
        blk_arg = jnp.argmin(t_blk, axis=1).astype(jnp.int32) + base
        # Strict < keeps the first (lowest-index) winner on ties, matching
        # the reference's `t2 >= t -> reject` (src/scene/ray_triangle.h:48).
        better = blk_min < best_t
        best_t = jnp.where(better, blk_min, best_t)
        best_idx = jnp.where(better, blk_arg, best_idx)
        return (best_t, best_idx), None

    r = o.shape[0]
    init = (jnp.full((r,), BIG, jnp.float32), jnp.full((r,), NO_HIT, jnp.int32))
    bases = jnp.arange(num_blocks, dtype=jnp.int32) * block_size
    (best_t, best_idx), _ = jax.lax.scan(body, init, (v0, v1, v2, valid, bases))
    return best_t, best_idx


def _sphere_best(o, d, spheres: SphereBuffer, eps):
    """Masked argmin over the (small) sphere table. Non-differentiable."""
    t, ok = sphere_intersect(
        o[:, None, :], d[:, None, :],
        spheres.center[None, :, :], spheres.radius[None, :], eps,
    )
    t = jnp.where(ok & spheres.valid[None, :], t, BIG)
    best_t = jnp.min(t, axis=1)
    best_idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    best_idx = jnp.where(best_t < BIG, best_idx, NO_HIT)
    return best_t, best_idx


def argmin_hit(
    o: jax.Array,
    d: jax.Array,
    scene: Scene,
    eps: jax.Array = EPS,
    block_size: int = 512,
    use_mxu: bool = True,
    tri_search=None,
    t_limit: jax.Array = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Find the winning primitive per ray: (best_t, prim_idx, is_sphere).

    Pure search — wrapped in stop_gradient by closest_hit. `tri_search` lets
    a backend (e.g. the sweep kernel) replace the triangle scan. `t_limit`
    (occlusion queries only) is a per-ray distance ceiling hint a backend
    may use to cull work; passing it never changes which hits count — the
    caller still compares best_t against its limit.
    """
    sph_t, sph_idx = _sphere_best(o, d, scene.spheres, eps)
    if tri_search is None:
        tri_t, tri_idx = _scan_blocks(o, d, scene.triangles, eps, block_size, use_mxu)
    else:
        hint = t_limit
        if hint is None:
            # Sphere-first culling: a real sphere hit is a true upper
            # bound on the winner, so triangle blocks entered beyond it
            # can never contain the closest hit — a free t-ceiling for a
            # culling search (misses are BIG, which culls nothing).
            hint = jax.lax.stop_gradient(sph_t)
        tri_t, tri_idx = tri_search(o, d, scene.triangles, eps, t_limit=hint)
    is_sphere = sph_t < tri_t
    best_t = jnp.where(is_sphere, sph_t, tri_t)
    prim = jnp.where(is_sphere, sph_idx, tri_idx)
    prim = jnp.where(best_t < BIG, prim, NO_HIT)
    return best_t, prim, is_sphere & (best_t < BIG)


def select_rows(table: jax.Array, idx: jax.Array, limit: int = 16) -> jax.Array:
    """jnp.take(table, idx, axis=0), as a static select chain when the
    table is tiny.

    The take VJP is a scatter-add over every update row (~2M at
    wavefront scale) regardless of the table size; for a <= `limit`-row
    table the select chain's VJP is `rows` masked reductions instead.
    Value-identical to take.
    """
    n = table.shape[0]
    if n > limit:
        return jnp.take(table, idx, axis=0)
    out = jnp.zeros(idx.shape + table.shape[1:], table.dtype)
    for j in range(n):
        out = jnp.where((idx == j)[..., None], table[j], out)
    return out


def packed_tri_table(tris: TriangleBuffer) -> jax.Array:
    """[N, 32] per-triangle row: every field the shading path needs.

    Layout: v0 v1 v2 (0:9) | n0 n1 n2 (9:18) | ka kd ks ke (18:30) |
    ns (30) | has_normals (31). One table means the winner fetch is ONE
    gather — and therefore ONE scatter-add in the VJP, whose cost grows
    with the update rows and hardly with the row width, so closest_hit
    and surface_attributes share a single gathered row.
    """
    return jnp.concatenate(
        [tris.v0, tris.v1, tris.v2, tris.n0, tris.n1, tris.n2,
         tris.ka, tris.kd, tris.ks, tris.ke, tris.ns[:, None],
         tris.has_normals[:, None].astype(jnp.float32)], axis=1)


def closest_hit(
    o: jax.Array,
    d: jax.Array,
    scene: Scene,
    eps: jax.Array = EPS,
    block_size: int = 512,
    use_mxu: bool = True,
    tri_search=None,
    with_row: bool = False,
):
    """Differentiable closest hit.

    The O(R*N) argmin search runs under stop_gradient; t/u/v are then
    *recomputed* differentiably on the single winning primitive per ray
    (an O(R) gather), so gradients w.r.t. geometry flow only through the
    winner — the correct local derivative away from visibility
    discontinuities, at O(R) backward cost.

    with_row=True additionally returns the winner's packed_tri_table row
    [R, 32] so the shading path reuses this gather instead of issuing a
    second one (one scatter-add instead of two in the backward).
    """
    # stop_gradient on the *inputs*: differentiation must never trace into
    # the search (the sweep kernel has no JVP rule, and the O(R*N) scan
    # would otherwise be linearized pointlessly).
    best_t, prim, is_sphere = argmin_hit(
        jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
        jax.lax.stop_gradient(scene), eps, block_size, use_mxu, tri_search,
    )
    safe_prim = jnp.maximum(prim, 0)

    # One packed gather (one scatter-add in the VJP) for everything the
    # pipeline needs from the winner, shading fields included.
    trow = jnp.take(packed_tri_table(scene.triangles), safe_prim, axis=0)
    t_tri, u_tri, v_tri, _ = mt_intersect(
        o, d, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9], eps)
    # Borderline winners can be accepted by the (differently-rounded)
    # backend search yet rejected by this recompute; fall back to the
    # search's own t (already non-differentiable) instead of leaving the
    # hit point at the BIG sentinel and shading the pixel black.
    t_tri = jnp.where(t_tri < BIG, t_tri, best_t)

    # Sphere recompute with fully sanitized masked lanes: non-sphere rays
    # evaluate a benign constant configuration (unit sphere, axis ray) so
    # no masked-lane pathology (r=0 padding, tangential disc=0, overflow)
    # can poison gradients via inf * 0.
    is_s = is_sphere
    sphere_prim = jnp.where(is_s, safe_prim, 0)
    sph_packed = jnp.concatenate(
        [scene.spheres.center, scene.spheres.radius[:, None]], axis=1)
    srow = select_rows(sph_packed, sphere_prim)  # [R, 4]
    c, r = srow[:, 0:3], srow[:, 3]
    m = is_s[:, None]
    o_s = jnp.where(m, o, jnp.asarray([0.0, 0.0, 3.0], o.dtype))
    d_s = jnp.where(m, d, jnp.asarray([0.0, 0.0, -1.0], d.dtype))
    c_s = jnp.where(m, c, 0.0)
    r_s = jnp.where(is_s, r, 1.0)
    t_sph, _ = sphere_intersect(o_s, d_s, c_s, r_s, eps)
    t_sph = jnp.where(t_sph < BIG, t_sph, best_t)  # same borderline fallback

    hit = prim >= 0
    t = jnp.where(is_sphere, t_sph, t_tri)
    t = jnp.where(hit, t, BIG)
    u = jnp.where(hit & ~is_sphere, u_tri, 0.0)
    v = jnp.where(hit & ~is_sphere, v_tri, 0.0)
    rec = HitRecord(t=t, u=u, v=v, prim=prim, is_sphere=is_sphere, hit=hit)
    return (rec, trow) if with_row else rec


def any_hit(
    o: jax.Array,
    d: jax.Array,
    t_limit: jax.Array,
    scene: Scene,
    eps: jax.Array = EPS,
    block_size: int = 512,
    use_mxu: bool = True,
    tri_search=None,
) -> jax.Array:
    """Occlusion query: does any primitive block (eps, t_limit)?

    The reference's `occlusion` (src/main.cpp:314-329) is an early-exit
    any-hit. A search hook with an `occlusion` method (the sweep kernel)
    runs it as an OR-fold with early exit; the XLA paths compute the
    closest hit under the t-ceiling and compare.
    Non-differentiable (boolean output). Spheres occlude too — an extension
    over the reference, which has no spheres.
    """
    t_limit = jax.lax.stop_gradient(t_limit)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene = jax.lax.stop_gradient(scene)
    occl_fn = getattr(tri_search, "occlusion", None)
    if occl_fn is not None:
        # Dedicated any-hit kernel: boolean OR fold, no argmin/index carry.
        tri_occ = occl_fn(o, d, t_limit, scene.triangles, eps)
        sph_t, _ = _sphere_best(o, d, scene.spheres, eps)
        return tri_occ | (sph_t < t_limit)
    best_t, _, _ = argmin_hit(
        o, d, scene, eps, block_size, use_mxu, tri_search, t_limit=t_limit,
    )
    return best_t < t_limit
