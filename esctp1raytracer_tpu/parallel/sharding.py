"""SPMD rendering and training over a jax.sharding.Mesh.

This is the framework's replacement for the reference's two runtime
parallelism strategies (SURVEY.md §2 strategy inventory):

* one-std::thread-per-image-row data parallelism (reference
  src/main.cpp:628-643) becomes the **'rays' mesh axis**: the flattened
  ray grid is sharded across devices with shard_map, the scene pytree is
  replicated (exactly the BASELINE plan: primitive table broadcast once
  per step);
* the ISPC SIMD-lanes-over-triangles strategy (src/ispc/trace.ispc:77-79)
  becomes the **'prims' mesh axis**: each device scans a slice of the
  primitive table and the running (t, index) minimum is combined with
  two O(rays) min all-reduces (pmin on t, then pmin on the tie-broken
  index) — the collective form of the blockwise closest-hit scan,
  independent of the axis size (an all_gather would move S*R tails).

Training adds what the reference lacks entirely: per-shard backward passes
with scene-parameter gradients all-reduced (`psum`) across the mesh, which
XLA overlaps with the backward computation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from esctp1raytracer_tpu.core.camera import Camera
from esctp1raytracer_tpu.core.intersect import NO_HIT, _scan_blocks
from esctp1raytracer_tpu.core.render import RenderConfig, trace_rays
from esctp1raytracer_tpu.scene.types import Scene

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


def make_mesh(
    devices=None,
    rays: Optional[int] = None,
    prims: int = 1,
) -> Mesh:
    """A ('rays', 'prims') device mesh. Default: all devices on 'rays'."""
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if rays is None:
        rays = n // prims
    if rays * prims != n:
        raise ValueError(f"mesh {rays}x{prims} != {n} devices")
    arr = np.asarray(devices).reshape(rays, prims)
    return Mesh(arr, (RAYS_AXIS, PRIMS_AXIS))


def _prim_sharded_search(cfg: RenderConfig, axis: str):
    """Triangle search with the primitive table split along a mesh axis.

    Each device scans its contiguous slice of the (replicated) table, then
    the per-shard running minima are combined with two `pmin`s over the
    axis (t, then the lowest index among shards at that t) — numerically
    identical to the single-device scan because ties resolve to the
    lowest triangle index on both levels.
    """

    def search(o, d, tris, eps, t_limit=None):
        # t_limit is a cull hint (see argmin_hit); the blockwise scan has
        # no per-block cull list, so it is unused here.
        n_shards = jax.lax.axis_size(axis)
        my = jax.lax.axis_index(axis)
        cap = tris.capacity
        if cap % n_shards:
            raise ValueError(
                f"triangle capacity {cap} is not divisible by the 'prims' "
                f"axis size {n_shards}; the trailing {cap % n_shards} "
                "triangles would never be tested. Pad the table (capacities "
                "are already padded to powers of two) or change the mesh."
            )
        shard = cap // n_shards
        base = my * shard
        local = jax.tree.map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, base, shard, axis=0), tris
        )
        t_loc, idx_loc = _scan_blocks(
            o, d, local, eps, min(cfg.block_size, shard), use_mxu=cfg.backend != "jnp"
        )
        idx_loc = jnp.where(idx_loc >= 0, idx_loc + base, NO_HIT)
        # Pairwise min-combine: two O(R) all-reduces instead of an
        # O(S*R) all_gather of every shard's tail. Ties at the global
        # min t resolve to the lowest triangle index (same semantics as
        # the single-device strict-< scan: shards are contiguous
        # ascending slices, so the lowest idx among min-t achievers is
        # the first-wins winner).
        t_best = jax.lax.pmin(t_loc, axis)  # [R]
        int_max = jnp.int32(np.iinfo(np.int32).max)
        cand = jnp.where((t_loc == t_best) & (idx_loc >= 0), idx_loc, int_max)
        idx_min = jax.lax.pmin(cand, axis)  # [R]
        idx_best = jnp.where(idx_min == int_max, NO_HIT, idx_min)
        return t_best, idx_best

    return search


_JIT_CACHE = {}


def _mesh_key(mesh: Mesh):
    return (
        tuple(int(dev.id) for dev in mesh.devices.flat),
        tuple(mesh.devices.shape),
        tuple(mesh.axis_names),
    )


def _cached_sharded_trace(mesh: Mesh, cfg: RenderConfig):
    """One jitted shard_map executable per (mesh, cfg).

    Defining + jitting the shard_map inside every render call re-traced
    the whole program each frame — the round-1 reason `sharded` was 7x
    slower than plain jit on one device. The executable is keyed on the
    mesh's device ids/shape and the (hashable) RenderConfig and reused."""
    key = ("trace", _mesh_key(mesh), cfg)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        use_prims = mesh.shape[PRIMS_AXIS] > 1
        tri_search = _prim_sharded_search(cfg, PRIMS_AXIS) if use_prims else None

        @jax.jit
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(RAYS_AXIS), P(RAYS_AXIS), P(RAYS_AXIS), P()),
            out_specs=P(RAYS_AXIS),
            check_vma=False,
        )
        def go(o_s, d_s, ids_s, scene_s):
            return trace_rays(o_s, d_s, scene_s, ids_s, cfg, tri_search=tri_search)

        _JIT_CACHE[key] = fn = go
    return fn


def _cached_sharded_grad(mesh: Mesh, cfg: RenderConfig):
    """Jitted sharded loss+grad executable per (mesh, cfg); see above."""
    key = ("grad", _mesh_key(mesh), cfg)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        use_prims = mesh.shape[PRIMS_AXIS] > 1
        tri_search = _prim_sharded_search(cfg, PRIMS_AXIS) if use_prims else None

        @jax.jit
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(RAYS_AXIS), P(RAYS_AXIS), P(RAYS_AXIS),
                      P(RAYS_AXIS), P(RAYS_AXIS), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        def go(params_s, o_s, d_s, ids_s, tgt_s, live_s, inv_n, scene_s):
            def local_loss(ps):
                sc = merge_params(scene_s, ps)
                color = trace_rays(o_s, d_s, sc, ids_s, cfg,
                                   tri_search=tri_search)
                err = jnp.where(live_s[:, None], color - tgt_s, 0.0)
                return jnp.sum(err * err) * inv_n

            loss, grads = jax.value_and_grad(local_loss)(params_s)
            # All-reduce across BOTH axes: ray shards sum partial
            # losses/grads; prim shards computed redundant shading, so
            # average over that axis.
            loss = jax.lax.psum(loss, RAYS_AXIS)
            grads = jax.lax.psum(grads, RAYS_AXIS)
            if use_prims:
                scale = 1.0 / mesh.shape[PRIMS_AXIS]
                loss = jax.lax.psum(loss, PRIMS_AXIS) * scale
                grads = jax.tree.map(
                    lambda g: jax.lax.psum(g, PRIMS_AXIS) * scale, grads
                )
            return loss, grads

        _JIT_CACHE[key] = fn = go
    return fn


def _pad_rays(o, d, ids, multiple: int):
    r = o.shape[0]
    pad = (-r) % multiple
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], d.dtype), (pad, 1))]
        )
        ids = jnp.concatenate([ids, jnp.arange(r, r + pad, dtype=ids.dtype)])
    return o, d, ids, r


def render_sharded(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """Render with the ray grid sharded over mesh axis 'rays' (and the
    primitive scan over 'prims' when that axis is > 1)."""
    if mesh is None:
        mesh = make_mesh()
    o, d = camera.ray_grid(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    n_rays_axis = mesh.shape[RAYS_AXIS]
    o, d, ids, r = _pad_rays(o, d, ids, n_rays_axis)

    color = _cached_sharded_trace(mesh, cfg)(o, d, ids, scene)
    return color[:r].reshape(height, width, 3)


# --------------------------------------------------------------------------
# Differentiable-parameter partitioning (float leaves of the Scene pytree)
# --------------------------------------------------------------------------

def float_params(scene: Scene):
    """Extract the differentiable (floating) leaves as a flat list."""
    leaves = jax.tree.leaves(scene)
    return [l for l in leaves if jnp.issubdtype(l.dtype, jnp.floating)]


def merge_params(scene: Scene, params) -> Scene:
    """Rebuild a Scene from float params + the original non-float leaves."""
    leaves, treedef = jax.tree.flatten(scene)
    it = iter(params)
    merged = [
        next(it) if jnp.issubdtype(l.dtype, jnp.floating) else l for l in leaves
    ]
    return jax.tree.unflatten(treedef, merged)


def loss_and_grad_sharded(
    scene: Scene,
    target: jax.Array,  # [H, W, 3]
    camera: Camera,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> Tuple[jax.Array, list]:
    """Mean-squared-error loss to a target image + psum'd scene grads.

    Every device renders its ray shard, runs the backward locally, and the
    scene-parameter gradients (replicated-scene cotangents) are
    all-reduced with psum across the whole mesh — overlapped with the
    backward pass by XLA. Returns (loss, grads-as-float-leaf-list).
    """
    if mesh is None:
        mesh = make_mesh()
    height, width = target.shape[0], target.shape[1]
    o, d = camera.ray_grid(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    tgt = target.reshape(-1, 3)
    n_rays_axis = mesh.shape[RAYS_AXIS]
    o, d, ids, r = _pad_rays(o, d, ids, n_rays_axis)
    pad = o.shape[0] - r
    if pad:
        tgt = jnp.concatenate([tgt, jnp.zeros((pad, 3), tgt.dtype)])
        live = jnp.concatenate([jnp.ones((r,), bool), jnp.zeros((pad,), bool)])
    else:
        live = jnp.ones((r,), bool)

    params = float_params(scene)
    inv_n = jnp.float32(1.0 / float(r * 3))
    return _cached_sharded_grad(mesh, cfg)(
        params, o, d, ids, tgt, live, inv_n, scene
    )


def train_step_sharded(
    scene: Scene,
    target: jax.Array,
    camera: Camera,
    lr: float = 1e-2,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> Tuple[Scene, jax.Array]:
    """One SGD step on all float scene parameters toward a target image —
    the full production fwd+bwd+all-reduce+update pipeline."""
    loss, grads = loss_and_grad_sharded(scene, target, camera, cfg, mesh)
    params = float_params(scene)
    new_params = [p - lr * g for p, g in zip(params, grads)]
    return merge_params(scene, new_params), loss
