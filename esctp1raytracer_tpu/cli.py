"""Command-line driver with reference-parity flags.

Mirrors the reference CLI (src/main.cpp:417-695):
  -m model.obj   path to the OBJ model
  -o out.ppm     output image (without it: "Nothing saved: use -o ...")
  -v x,y,z       eye position        (default 0,1,3 — src/main.cpp:426)
  -l x,y,z       look-at point       (default 0,1,0)
  -w w,h         window size         (default 1024,768 — and unlike the
                 reference, -w actually works; quirk 7 fixed)
  --thread --bvh --ispc   the reference's execution strategies, mapped to
                 the framework's backends (see table below)
  --test         run the built-in self-checks (the reference's vestigial
                 test.ispc intent, done properly)
  --debug --trace   verbosity levels (src/debug.h)

Strategy mapping (reference -> framework):
  (none)    sequential C++ loop      -> backend "jnp"   (single-device jit)
  --thread  one thread per row       -> mode  "sharded" (ray grid over mesh)
  --ispc    SIMD over triangles      -> backend "auto" (the sweep kernel on
            a GPU, the jnp reference on the CPU)
  --bvh     flatten + BVH            -> backend "mxu"   (feature contraction;
            the reference BVH is slower than its own brute force, SURVEY
            quirk 3, so the accelerated path here is the feature search)
  --bvh --thread  accelerated+threads -> mode "sharded" backend "auto"
Explicit --mode/--backend win over the mapped flags, and compose:
`--mode sharded --backend sweep` shards the sweep kernel over the mesh.

Extensions: --depth (Whitted reflection bounces), --seed, --vfov,
--light-mode {area,reference_cpp}, --chunk.

The stderr timing block reproduces the reference's report fields
(src/main.cpp:645-654).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from esctp1raytracer_tpu.core.render import BACKENDS
from esctp1raytracer_tpu.utils.debug import DEBUG, INFO, TRACE, get_logger, set_level

logger = get_logger(__name__)


def _vec3(text: str):
    parts = [float(x) for x in text.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z got {text!r}")
    return tuple(parts)


def _vec2i(text: str):
    parts = [int(x) for x in text.split(",")]
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected w,h got {text!r}")
    return tuple(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="esctp1raytracer_tpu",
        description="Differentiable Whitted ray tracer in JAX",
    )
    p.add_argument("-m", dest="model", default="", help="OBJ model path")
    p.add_argument("-o", dest="output", default="", help="output PPM path")
    p.add_argument("-v", dest="eye", type=_vec3, default=(0.0, 1.0, 3.0),
                   help="eye position x,y,z")
    p.add_argument("-l", dest="look", type=_vec3, default=(0.0, 1.0, 0.0),
                   help="look-at point x,y,z")
    p.add_argument("-w", dest="window", type=_vec2i, default=(1024, 768),
                   help="window size w,h")
    p.add_argument("--thread", action="store_true",
                   help="reference strategy: data-parallel (-> sharded mesh)")
    p.add_argument("--bvh", action="store_true",
                   help="reference strategy: accelerated (-> mxu backend)")
    p.add_argument("--ispc", action="store_true",
                   help="reference strategy: SIMD (-> auto backend)")
    p.add_argument("--test", action="store_true", help="run self-tests and exit")
    p.add_argument("--debug", action="store_true", help="debug verbosity")
    p.add_argument("--trace", action="store_true", help="trace verbosity")
    p.add_argument("--mode", dest="mode", default="",
                   choices=["", "single", "sharded", *BACKENDS],
                   help="execution mode: single device or sharded over the "
                        "mesh (a backend name here is legacy shorthand for "
                        "--backend NAME)")
    p.add_argument("--backend", dest="backend", default="",
                   choices=["", *BACKENDS],
                   help="kernel backend; composes with --mode sharded "
                        "(overrides strategy flags)")
    p.add_argument("--depth", type=int, default=1, help="reflection bounces")
    p.add_argument("--seed", type=int, default=0, help="light-sampling seed")
    p.add_argument("--vfov", type=float, default=60.0, help="vertical fov (deg)")
    p.add_argument("--chunk", type=int, default=0,
                   help="rays per wavefront (0 = whole grid, fastest)")
    p.add_argument("--light-mode", default="area",
                   choices=["area", "reference_cpp"],
                   help="area sampling (corrected) or reference-C++ compat")
    p.add_argument("--scene", default="",
                   choices=["", "cornell", "cornell_mirror", "cornell_glossy",
                            "cornell_sphere", "cornell_water",
                            "cornell_empty_co", "cornell_empty_rg",
                            "cornell_empty_white", "cornell_empty_squashed",
                            "cornell_empty_nolight", "sphere_plane",
                            "ten_sphere", "mesh", "mixed", "random100k"],
                   help="procedural scene instead of -m")
    return p


def self_test() -> int:
    """Vector-math and intersection self-checks — the working version of
    the reference's commented-out test.ispc (src/ispc/test.ispc:22-38)."""
    import jax.numpy as jnp

    from esctp1raytracer_tpu.core.intersect import mt_intersect, sphere_intersect

    checks = []
    a = jnp.asarray([1.0, 0.0, 0.0])
    b = jnp.asarray([0.0, 1.0, 0.0])
    checks.append(("dot orthogonal", float(jnp.dot(a, b)) == 0.0))
    checks.append(("cross right-handed",
                   bool(jnp.allclose(jnp.cross(a, b), jnp.asarray([0.0, 0.0, 1.0])))))
    t, u, v, ok = mt_intersect(
        jnp.asarray([0.25, 0.25, 1.0]), jnp.asarray([0.0, 0.0, -1.0]),
        jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]),
    )
    checks.append(("triangle hit", bool(ok) and abs(float(t) - 1.0) < 1e-6))
    t, ok = sphere_intersect(
        jnp.asarray([0.0, 0.0, 3.0]), jnp.asarray([0.0, 0.0, -1.0]),
        jnp.zeros(3), jnp.asarray(1.0),
    )
    checks.append(("sphere hit", bool(ok) and abs(float(t) - 2.0) < 1e-5))

    failed = [name for name, passed in checks if not passed]
    for name, passed in checks:
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    print(f"Self-test: {len(checks) - len(failed)}/{len(checks)} passed")
    return 1 if failed else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.trace:
        set_level(TRACE)
    elif args.debug:
        set_level(DEBUG)
    else:
        set_level(INFO)

    if args.test:
        return self_test()

    # Heavy imports after flag parsing so --help/--test stay fast.
    import jax

    from esctp1raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from esctp1raytracer_tpu import (
        Camera, RenderConfig, render, scene_from_mesh, write_ppm,
    )
    from esctp1raytracer_tpu.scene import builders
    from esctp1raytracer_tpu.utils.timing import Timer

    if args.model:
        from esctp1raytracer_tpu.scene.matjson import load_obj_with_mat

        # Applies a sibling <model>.mat JSON override when present — the
        # convention the reference set up but never wired in.
        scene = scene_from_mesh(load_obj_with_mat(args.model))
    elif args.scene:
        scene = {
            "cornell": builders.cornell_box,
            "cornell_mirror": lambda: builders.cornell_variant("mirror"),
            "cornell_glossy": lambda: builders.cornell_variant("glossy"),
            "cornell_sphere": lambda: builders.cornell_variant("sphere"),
            "cornell_water": lambda: builders.cornell_variant("water"),
            "cornell_empty_co": lambda: builders.cornell_variant("empty_co"),
            "cornell_empty_rg": lambda: builders.cornell_variant("empty_rg"),
            "cornell_empty_white":
                lambda: builders.cornell_variant("empty_white"),
            "cornell_empty_squashed":
                lambda: builders.cornell_variant("empty_squashed"),
            "cornell_empty_nolight":
                lambda: builders.cornell_variant("empty_nolight"),
            "sphere_plane": builders.sphere_plane_scene,
            "ten_sphere": builders.ten_sphere_scene,
            "mesh": builders.mesh_scene,
            "mixed": builders.mixed_scene,
            "random100k": lambda: builders.random_scene(100_000),
        }[args.scene]()
    else:
        print("No model: use -m model.obj or --scene", file=sys.stderr)
        return 2

    width, height = args.window
    mode, backend = args.mode, args.backend
    if mode in BACKENDS:  # legacy: --mode <backend>
        backend = backend or mode
        mode = "single"
    if not mode:
        mode = "sharded" if args.thread else "single"
    if not backend:
        if args.ispc:
            backend = "auto"
        elif args.bvh:
            # --bvh --thread: accelerated + data-parallel -> the best
            # kernel for the scene, sharded over the mesh.
            backend = "auto" if mode == "sharded" else "mxu"
        elif mode == "sharded":
            backend = "auto"
        else:
            backend = "jnp"

    cam = Camera.look_at(args.eye, args.look, vfov=args.vfov,
                         aspect=width / height)
    cfg = RenderConfig(backend=backend, depth=args.depth, seed=args.seed,
                       ray_chunk=args.chunk, light_mode=args.light_mode)

    with Timer("render") as timer:
        if mode == "sharded":
            from esctp1raytracer_tpu.parallel import make_mesh, render_sharded

            image = render_sharded(scene, cam, width, height, cfg, make_mesh())
        else:
            image = render(scene, cam, width, height, cfg)
        image = jax.block_until_ready(image)

    # stderr timing block, same fields as the reference (src/main.cpp:645-654).
    timer.fields = {
        "Threaded": str(mode == "sharded").lower(),
        "Flattened": str(backend == "mxu").lower(),
        "ISPC": str(args.ispc).lower(),
        "Mode": f"{mode}/{backend}",
        "Devices": jax.device_count(),
    }
    timer.report()

    if args.output:
        write_ppm(args.output, np.asarray(image))
        print(f"Rendered image in: {args.output}")
    else:
        print("Nothing saved: use -o to save rendered image")
    return 0


if __name__ == "__main__":
    sys.exit(main())
