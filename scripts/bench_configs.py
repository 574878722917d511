#!/usr/bin/env python
"""BASELINE.json config matrix benchmark on one GPU, in one process.

Prints a JSON line per config: forward ms, forward+backward ms, rays/s,
the resolved backend and the device. Heavier than bench.py; use it to
track per-config performance.

  1. sphere+plane        256x256   depth 1
  2. 10-sphere + shadows 512x512   depth 2
  3. ~10k-tri mesh       1920x1080 depth 1
  4. mixed sphere+mesh   1920x1080 depth 4 (differentiable)
  5. 100k-tri soup       3840x2160 depth 1

Usage: python scripts/bench_configs.py [name-substring] [--json=PATH]
ESCTP_BENCH_BACKEND picks the backend (default "auto").
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu import Camera, RenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import BACKENDS, resolve_backend, trace_rays  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu.scene import builders  # noqa: E402
from esctp1raytracer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from esctp1raytracer_tpu.utils.device import require_gpu  # noqa: E402

CONFIGS = [
    ("sphere_plane_256", builders.sphere_plane_scene, (0, 2, 6), 256, 256, 1),
    ("ten_sphere_512", builders.ten_sphere_scene, (0, 4, 8), 512, 512, 2),
    ("mesh10k_1080p", lambda: builders.mesh_scene(4), (0, 2, 6), 1920, 1080, 1),
    ("mixed_1080p_d4", builders.mixed_scene, (0, 2.5, 7), 1920, 1080, 4),
    ("soup100k_4k", lambda: builders.random_scene(100_000), (0, 18, 45), 3840, 2160, 1),
]


def timeit(fn, *args, iters=2, batches=2):
    """Best mean of pipelined batches; the caller has warmed fn."""
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*args) for _ in range(iters)])
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def run_config(device, backend, name, make_scene, eye, width, height, depth):
    scene = make_scene()
    cam = Camera.look_at(eye, (0, 1, 0), vfov=60.0, aspect=width / height)
    cfg = RenderConfig(backend=backend, depth=depth)
    o, d = cam.ray_grid(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    params = float_params(scene)

    def loss(ps, o, d, ids):
        return jnp.sum(trace_rays(o, d, merge_params(scene, ps), ids, cfg) ** 2)

    fwd = jax.jit(loss)
    bwd = jax.jit(jax.grad(loss))
    t0 = time.perf_counter()
    jax.block_until_ready(fwd(params, o, d, ids))
    jax.block_until_ready(bwd(params, o, d, ids))
    compile_s = time.perf_counter() - t0
    dt_f = timeit(fwd, params, o, d, ids)
    dt_b = timeit(bwd, params, o, d, ids)
    rays = o.shape[0]
    return {
        "config": name, "rays": rays, "tris": scene.num_triangles,
        "depth": depth, "backend": resolve_backend(cfg),
        "platform": device["platform"], "device_kind": device["kind"],
        "device_count": device["count"], "compile_s": compile_s,
        "forward_ms": dt_f * 1e3, "forward_rays_per_s": rays / dt_f,
        "fwd_bwd_ms": dt_b * 1e3, "fwd_bwd_rays_per_s": rays / dt_b,
    }


def main():
    device = require_gpu()
    enable_compile_cache()
    backend = os.environ.get("ESCTP_BENCH_BACKEND", "auto")
    if backend not in BACKENDS:
        sys.exit(f"ESCTP_BENCH_BACKEND={backend!r}: one of {BACKENDS}")
    args = [a for a in sys.argv[1:] if not a.startswith("--json")]
    json_path = next((a.split("=", 1)[1] for a in sys.argv[1:]
                      if a.startswith("--json=")), None)
    only = args[0] if args else ""
    records = []
    for name, *rest in CONFIGS:
        if only in name:
            records.append(run_config(device, backend, name, *rest))
            print(json.dumps(records[-1]), flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(records, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
