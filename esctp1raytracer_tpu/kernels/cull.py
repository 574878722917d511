"""Slab tests of rays against triangle-tile boxes: the cull pre-pass of the
sweep kernel's culled entry (kernels/sweep_gpu.py).

`group_cull_mask` tests each group of rays (one kernel program's rays)
against every Morton-sorted tile's box at once, from the interval hull
of the group's origins and directions; the kernel then loops over the
kept tiles only. This plays the culling role of the reference BVH
(src/main.cpp:98-171). `block_cull_mask` is the exact per-ray test the
group mask is checked against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def block_cull_mask(o: jax.Array, d: jax.Array, aabbs: jax.Array,
                    t_limit: jax.Array = None) -> jax.Array:
    """Slab-test rays [R, 3] against block AABBs [8, NB] -> mask [R, NB].

    NaN-safe: a zero direction component whose origin sits exactly on a
    slab plane yields 0 * inf = NaN; the negated comparison form makes
    those lanes fall through to "keep" — a conservative extra block test
    instead of a wrongly culled (potentially hit) block.

    With `t_limit` [R] set (shadow/occlusion rays), blocks whose slab
    entry lies beyond the limit are culled too — the t-ceiling analogue of
    the reference's early-exit occlusion (src/main.cpp:314-329).
    """
    inv = 1.0 / d  # inf on zero components is correct slab behavior
    bmin = aabbs[0:3].T  # [NB, 3]
    bmax = aabbs[3:6].T
    t0 = (bmin[None] - o[:, None]) * inv[:, None]  # [R, NB, 3]
    t1 = (bmax[None] - o[:, None]) * inv[:, None]
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    reject = (tn > tf) | (tf < 0.0)
    if t_limit is not None:
        reject |= tn > t_limit[:, None]
    return ~reject


def group_cull_mask(o: jax.Array, d: jax.Array, aabbs: jax.Array,
                    t_limit: jax.Array, group: int) -> jax.Array:
    """Interval slab test per `group`-ray bundle -> mask [R/group, NB].

    Stands in for per-ray `block_cull_mask` + the group OR-fold with ONE
    conservative slab test per bundle built from component intervals
    (min/max of o and d over the group's rays, interval reciprocal of d).
    `group`x fewer slab tests. Extra kept blocks cost sweep time only,
    never correctness: the kernel re-tests every triangle of a kept tile.

    Conservative by construction: for each axis the per-bundle entry
    (exit) bound is the min (max) over the interval-corner products, so
    tn <= every ray's slab entry and tf >= every ray's slab exit; a
    direction-component sign flip inside the bundle unbounds that axis.
    NaN lanes (origin exactly on a slab plane x overflowed reciprocal)
    fall through every comparison to "keep" — same conservative direction
    as block_cull_mask's NaN note. With `t_limit` [R], the ceiling is the
    bundle max (rays with t_limit < 0 contribute no ceiling of their own).
    """
    nb = o.shape[0] // group
    ob = o.reshape(nb, group, 3)
    db = d.reshape(nb, group, 3)
    o_lo, o_hi = jnp.min(ob, axis=1), jnp.max(ob, axis=1)
    d_lo, d_hi = jnp.min(db, axis=1), jnp.max(db, axis=1)
    unbounded = (d_lo <= 0.0) & (d_hi >= 0.0)  # sign flip (or exact zero)
    inv_a = 1.0 / jnp.where(unbounded, 1.0, d_hi)
    inv_b = 1.0 / jnp.where(unbounded, 1.0, d_lo)
    inv_lo = jnp.minimum(inv_a, inv_b)
    inv_hi = jnp.maximum(inv_a, inv_b)
    bmin = aabbs[0:3].T  # [NB, 3]
    bmax = aabbs[3:6].T
    big = jnp.float32(3.4e38)
    tn = jnp.full((nb, bmin.shape[0]), -big, jnp.float32)
    tf = jnp.full((nb, bmin.shape[0]), big, jnp.float32)
    for a in range(3):
        lo1 = bmin[None, :, a] - o_hi[:, a:a + 1]
        hi1 = bmin[None, :, a] - o_lo[:, a:a + 1]
        lo2 = bmax[None, :, a] - o_hi[:, a:a + 1]
        hi2 = bmax[None, :, a] - o_lo[:, a:a + 1]
        il, ih = inv_lo[:, a:a + 1], inv_hi[:, a:a + 1]
        p = [lo1 * il, lo1 * ih, hi1 * il, hi1 * ih,
             lo2 * il, lo2 * ih, hi2 * il, hi2 * ih]
        near = p[0]
        far = p[0]
        for q in p[1:]:
            near = jnp.minimum(near, q)
            far = jnp.maximum(far, q)
        unb = unbounded[:, a:a + 1]
        near = jnp.where(unb, -big, near)
        far = jnp.where(unb, big, far)
        tn = jnp.maximum(tn, near)
        tf = jnp.minimum(tf, far)
    reject = (tn > tf) | (tf < 0.0)
    if t_limit is not None:
        # NaN tn compares False here too -> keep (conservative).
        tl_hi = jnp.max(t_limit.reshape(nb, group), axis=1)
        reject |= tn > tl_hi[:, None]
    return ~reject
