"""Benchmark: rays/s on one GPU, forward + backward, at 1080p (BASELINE.json).

Workload: ~10k-triangle scene (two icospheres + ground + area light),
1920x1080 camera, one light source — BASELINE config 3 geometry with the
full differentiable pipeline (forward render + backward to all scene
parameters), the reference-lacking capability that defines this framework.

vs_baseline compares against the measured wall-clock of the reference C++
renderer (`reference_baseline.json`; the reference publishes no numbers —
BASELINE.md) on its canonical workload, Cornell 1024x768 forward.

Runs in one process and prints ONE JSON line naming the device and the
card. Any failure, or a platform other than a GPU, exits non-zero.
ESCTP_BENCH_BACKEND picks the backend (default "auto").
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from esctp1raytracer_tpu import Camera, RenderConfig, cornell_box
from esctp1raytracer_tpu.core.render import BACKENDS, resolve_backend, trace_rays
from esctp1raytracer_tpu.parallel.sharding import float_params, merge_params
from esctp1raytracer_tpu.scene.builders import (
    _area_light,
    _ground_plane,
    icosphere_mesh,
    scene_from_mesh,
)
from esctp1raytracer_tpu.utils.compile_cache import enable_compile_cache
from esctp1raytracer_tpu.utils.device import card_name_and_power_limit, require_gpu

WIDTH, HEIGHT = 1920, 1080
DEPTH = 1  # primary + shadow rays, matching the reference pipeline shape


def build_scene():
    meshes = [
        icosphere_mesh(subdivisions=4, radius=1.0, center=(-1.3, 1.0, 0.0)),
        icosphere_mesh(subdivisions=4, radius=1.0, center=(1.3, 1.0, 0.0),
                       smooth=False),
        _ground_plane(),
        _area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]
    return scene_from_mesh(meshes)  # 2*5120 + 2 + 2 = 10244 tris -> padded


def camera_rays(cam, width, height):
    o, d = cam.ray_grid(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    return o, d, jnp.arange(o.shape[0], dtype=jnp.uint32)


def time_it(fn, *args, iters=5, batches=3):
    """Best mean of several pipelined batches, host clock around
    block_until_ready (warm: the caller has compiled fn)."""
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*args) for _ in range(iters)])
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main():
    device = require_gpu()
    card = card_name_and_power_limit()
    enable_compile_cache()
    backend = os.environ.get("ESCTP_BENCH_BACKEND", "auto")
    if backend not in BACKENDS:
        sys.exit(f"ESCTP_BENCH_BACKEND={backend!r}: one of {BACKENDS}")
    cfg = RenderConfig(backend=backend, depth=DEPTH)

    t_setup = time.perf_counter()
    scene = build_scene()
    cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0,
                         aspect=WIDTH / HEIGHT)
    o, d, ids = camera_rays(cam, WIDTH, HEIGHT)
    params = float_params(scene)

    def loss_fn(ps, o, d, ids):
        color = trace_rays(o, d, merge_params(scene, ps), ids, cfg)
        return jnp.sum(color * color)

    fwd_bwd = jax.jit(jax.grad(loss_fn))
    fwd_only = jax.jit(loss_fn)
    jax.block_until_ready(fwd_bwd(params, o, d, ids))
    jax.block_until_ready(fwd_only(params, o, d, ids))
    setup_compile_s = time.perf_counter() - t_setup

    dt_fb = time_it(fwd_bwd, params, o, d, ids)
    dt_f = time_it(fwd_only, params, o, d, ids)
    num_rays = o.shape[0]
    print(f"forward only : {dt_f*1e3:8.2f} ms  {num_rays/dt_f/1e6:8.2f} Mrays/s",
          file=sys.stderr)
    print(f"forward+bwd  : {dt_fb*1e3:8.2f} ms  {num_rays/dt_fb/1e6:8.2f} Mrays/s",
          file=sys.stderr)

    # vs_baseline: like-for-like with the measured reference C++ renderer
    # on ITS canonical workload (Cornell 1024x768 forward, best strategy:
    # --thread).
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "reference_baseline.json")) as fh:
        ref_rays = json.load(fh)["rays_per_s_forward"]
    cscene = cornell_box()
    ccam = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0,
                          aspect=1024 / 768)
    co, cd, cids = camera_rays(ccam, 1024, 768)
    cf = jax.jit(lambda o, d, ids: trace_rays(o, d, cscene, ids, cfg))
    jax.block_until_ready(cf(co, cd, cids))
    dt_c = time_it(cf, co, cd, cids)
    cornell_rays = co.shape[0] / dt_c
    vs_baseline = cornell_rays / ref_rays
    print(f"cornell fwd  : {dt_c*1e3:8.2f} ms  {cornell_rays/1e6:8.2f} "
          f"Mrays/s  ({vs_baseline:.1f}x reference --thread)", file=sys.stderr)

    print(json.dumps({
        "metric": "rays_per_s_fwd_bwd_1080p",
        "value": num_rays / dt_fb,
        "unit": "rays/s",
        "vs_baseline": vs_baseline,
        "forward_rays_per_s": num_rays / dt_f,
        "backend": resolve_backend(cfg),
        "setup_compile_s": setup_compile_s,
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "card": card,
    }))


if __name__ == "__main__":
    main()
