"""The renderer: camera rays -> closest hit -> shade -> (reflect)* -> image.

This replaces the reference's three tracer cores (`scan_row`
src/main.cpp:698-882, the C dispatch chain src/main.cpp:176-312, and the
ISPC `trace` kernel src/ispc/trace.ispc:86-272) with one fused, jitted
pipeline over the whole ray grid. The per-pixel double loop becomes array
ops; the per-row threading strategy becomes ray-chunking (`lax.map`) on one
device and mesh sharding in parallel/; and the scalar recursion the
reference never had is an iterative fixed-depth Whitted reflection loop
(statically unrolled — depth <= ~4), end-to-end differentiable.

Backends (RenderConfig.backend):
  "jnp"   — the plain reference: blockwise broadcast Möller–Trumbore;
  "mxu"   — the same search as a float32 feature contraction in XLA;
  "sweep" — the closest-hit / any-hit Pallas kernel for the GPU
            (kernels/sweep_gpu.py);
  "auto"  — decided by platform in `resolve_backend`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from esctp1raytracer_tpu.core.camera import Camera
from esctp1raytracer_tpu.core.intersect import EPS, any_hit, closest_hit
from esctp1raytracer_tpu.core.shading import shade
from esctp1raytracer_tpu.scene.types import Scene


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable; safe as a jit static arg).

    eps mirrors the reference's intersection epsilon
    (std::numeric_limits<float>::epsilon(), src/scene/ray_triangle.h:23);
    shadow_eps is the hit-point back-off / shadow-ray limit epsilon, where
    we standardize on the ISPC backend's 1e-4 (src/ispc/ispc_helpers.h:5)
    — the C++ float-eps value is numerically meaningless at scene scale
    (documented divergence).
    """

    depth: int = 1
    eps: float = float(EPS)
    shadow_eps: float = 1e-4
    block_size: int = 512
    ray_chunk: int = 0  # 0 = trace all rays in one wavefront
    backend: str = "jnp"  # one of BACKENDS
    seed: int = 0
    # "area" = corrected ISPC-style area-light sampling;
    # "reference_cpp" = bit-faithful reproduction of the C++ path's
    # degenerate corner sampling (quirk 2) for golden-image parity.
    light_mode: str = "area"
    # Run the sweep kernel in the Pallas interpreter (tests on the CPU).
    interpret: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Retired backend names, and what replaces each.
_REMOVED = {
    "lane": "sweep", "tile": "sweep", "mxtile": "sweep", "fused": "auto",
    "pallas": "auto",
}
BACKENDS = ("jnp", "mxu", "sweep", "auto")


def resolve_backend(cfg: RenderConfig) -> str:
    """The concrete search backend for `cfg` on the default platform.

    "auto" is decided once, by platform: the sweep kernel on "gpu", and
    on "cpu" the plain `jnp` reference, which is the CPU program. Any
    other platform raises. The sweep kernel on a non-GPU platform raises
    unless `cfg.interpret` asks for the Pallas interpreter.
    """
    backend = cfg.backend
    if backend in _REMOVED:
        raise ValueError(
            f"backend {backend!r} was removed; use {_REMOVED[backend]!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    platform = jax.default_backend()
    if backend == "auto":
        if platform == "gpu":
            return "sweep"
        if platform == "cpu":
            return "jnp"
        raise ValueError(f"backend 'auto' has no route on {platform!r}")
    if backend == "sweep" and platform != "gpu" and not cfg.interpret:
        raise ValueError(
            f"the sweep kernel compiles only for a GPU, not {platform!r}; "
            "pass interpret=True to run it in the Pallas interpreter")
    return backend


def _search_fns(cfg: RenderConfig):
    """(tri_search hook or None, use_mxu) for the resolved backend."""
    backend = resolve_backend(cfg)
    if backend == "sweep":
        from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch

        return SweepSearch(interpret=cfg.interpret), False
    return None, backend == "mxu"


def trace_rays(
    o: jax.Array,
    d: jax.Array,
    scene: Scene,
    ray_ids: jax.Array,
    cfg: RenderConfig,
    tri_search=None,
) -> jax.Array:
    """Trace one wavefront of rays [R, 3] to colors [R, 3].

    Depth-1 is exactly the reference pipeline (primary ray + shadow rays);
    depth>1 adds iterative Whitted reflections: throughput *= ks, ray
    reflects about the shading normal, contributions accumulate — the
    "iterative fixed-depth bounce loop" from BASELINE.json that replaces
    scalar recursion.

    When cfg.ray_chunk > 0 and R exceeds it, rays stream through
    `lax.map` in ray_chunk-sized wavefronts, bounding the [chunk, block]
    intermediates in HBM; the counter-based RNG makes the result
    independent of the chunking.
    """
    r = o.shape[0]
    if cfg.ray_chunk and cfg.ray_chunk < r:
        chunk = cfg.ray_chunk
        pad = (-r) % chunk
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate(
                [d, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], d.dtype), (pad, 1))]
            )
            ray_ids = jnp.concatenate(
                [ray_ids, jnp.zeros((pad,), ray_ids.dtype)]
            )
        inner = cfg.replace(ray_chunk=0)

        def one_chunk(args):
            oc, dc, ids = args
            return trace_rays(oc, dc, scene, ids, inner, tri_search)

        color = jax.lax.map(
            one_chunk,
            (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3),
             ray_ids.reshape(-1, chunk)),
        )
        return color.reshape(-1, 3)[:r]
    backend_search, use_mxu = _search_fns(cfg)
    if tri_search is None:
        tri_search = backend_search
    eps = jnp.float32(cfg.eps)

    def occl(oo, dd, t_limit):
        return any_hit(
            oo, dd, t_limit, scene, eps,
            block_size=cfg.block_size, use_mxu=use_mxu, tri_search=tri_search,
        )

    r = o.shape[0]
    color = jnp.zeros((r, 3), jnp.float32)
    throughput = jnp.ones((r, 3), jnp.float32)
    active = jnp.ones((r,), bool)

    from esctp1raytracer_tpu.utils.debug import TRACE, current_level

    for bounce in range(cfg.depth):
        # with_row: the winner's packed table row is gathered once here
        # and shared with shading — one scatter-add per bounce in the
        # VJP instead of two.
        hit, trow = closest_hit(
            o, d, scene, eps,
            block_size=cfg.block_size, use_mxu=use_mxu, tri_search=tri_search,
            with_row=True,
        )
        if current_level() >= TRACE:
            # The reference dumps per-hit info under --trace
            # (src/ispc/trace.ispc:94-100, src/main.cpp:607-616); at
            # wavefront scale that becomes a per-bounce hit summary plus
            # the first ray's hit record, printed from the device.
            jax.debug.print(
                "trace[bounce " + str(bounce) + "]: hits={h}/{r} "
                "t[0]={t0} prim[0]={p0} u[0]={u0} v[0]={v0}",
                h=jnp.sum(hit.hit), r=hit.hit.shape[0],
                t0=hit.t[0], p0=hit.prim[0], u0=hit.u[0], v0=hit.v[0],
            )
        local, hit_p, normal, ks = shade(
            o, d, hit, scene, cfg.seed, ray_ids, occl,
            shadow_eps=cfg.shadow_eps, bounce=bounce, light_mode=cfg.light_mode,
            trow=trow,
        )
        color = color + throughput * jnp.where(active[:, None], local, 0.0)
        if bounce + 1 < cfg.depth:
            active = active & hit.hit & (jnp.max(ks, axis=-1) > 0.0)
            throughput = jnp.where(active[:, None], throughput * ks, 0.0)
            d_dot_n = jnp.sum(d * normal, axis=-1, keepdims=True)
            refl = d - 2.0 * d_dot_n * normal
            refl = refl * jax.lax.rsqrt(
                jnp.maximum(jnp.sum(refl * refl, axis=-1, keepdims=True), 1e-12)
            )
            o = jnp.where(active[:, None], hit_p, o)
            d = jnp.where(active[:, None], refl, d)
    return color


@partial(jax.jit, static_argnames=("width", "height", "cfg"))
def render(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
) -> jax.Array:
    """Render a [height, width, 3] float32 image.

    Row h of the result is image row h in the reference's framebuffer
    layout (image[h*W+w], src/main.cpp:786-788); the PPM writer emits rows
    top-to-bottom as h = H-1 .. 0 exactly like src/main.cpp:661.
    """
    o, d = camera.ray_grid(width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    ray_ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    color = trace_rays(o, d, scene, ray_ids, cfg)
    return color.reshape(height, width, 3)


def render_to_numpy(scene, camera, width, height, cfg=RenderConfig()) -> np.ndarray:
    return np.asarray(jax.block_until_ready(render(scene, camera, width, height, cfg)))
