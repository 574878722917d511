#!/usr/bin/env python
"""Strategy-matrix runner — the reference's scripts/run.sh, framework-side.

Renders the canonical Cornell workload once per execution strategy
{sequential(jnp), --thread(sharded), --bvh(mxu), --ispc(pallas)}, writes
output<suffix>.ppm files, prints the per-strategy timing table, and
cross-checks the images against each other (the reference's de-facto
golden comparison, done automatically instead of by eye).

Usage: python scripts/run_matrix.py [--out DIR] [--size WxH] [--scene ...]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import dataclasses
import os
import sys
import time


os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])

from esctp1raytracer_tpu import Camera, RenderConfig, render, write_ppm  # noqa: E402
from esctp1raytracer_tpu.parallel import make_mesh, render_sharded  # noqa: E402

STRATEGIES = [
    # (suffix, backend, sharded) — one row per reference strategy
    # (scripts/run.sh:36-41: none, --thread, --bvh, --bvh --thread, --ispc),
    # same mapping as the CLI strategy flags (cli.py:main).
    ("sequential", "jnp", False),
    ("thread", "auto", True),   # best kernel, sharded over the device mesh
    ("bvh", "mxu", False),
    ("bvh_thread", "auto", True),  # accelerated search + sharded rays
    ("ispc", "auto", False),  # auto: the sweep kernel on a GPU
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/plain")
    ap.add_argument("--size", default="1024x768")
    ap.add_argument("--eye", default="0,1,2")
    ap.add_argument("--look", default="0,1,0")
    ap.add_argument("--scene", default="original",
                    choices=("original", "mirror", "glossy", "sphere",
                             "water", "empty_co", "empty_rg", "empty_white",
                             "empty_squashed", "empty_nolight"),
                    help="Cornell model variant (src/models/cornell/*)")
    ap.add_argument("--depth", type=int, default=1,
                    help="Whitted reflection bounces")
    ap.add_argument("--json", default="",
                    help="also write the strategy table as JSON (the "
                         "committed on-chip artifact, e.g. RUN_MATRIX.json)")
    ap.add_argument("--golden", default="",
                    help="path to tests/golden/cornell_cpp_mean.npz: render "
                         "light_mode=reference_cpp at FULL size (4 seeds "
                         "averaged, the reference's own nondeterminism "
                         "model) and record the diff statistics vs the "
                         "reference binary's mean image — the full-res "
                         "on-chip version of tests/test_golden.py")
    args = ap.parse_args()
    width, height = (int(x) for x in args.size.split("x"))
    eye = tuple(float(x) for x in args.eye.split(","))
    look = tuple(float(x) for x in args.look.split(","))

    os.makedirs(args.out, exist_ok=True)
    from esctp1raytracer_tpu.scene.builders import cornell_variant

    scene = cornell_variant(args.scene)
    cam = Camera.look_at(eye, look, vfov=60.0, aspect=width / height)
    mesh = make_mesh()

    # RUN_MATRIX_STRATEGIES=sequential,ispc limits the legs (smoke tests,
    # quick iterations); default = all five reference strategies.
    strategies = STRATEGIES
    env_filter = os.environ.get("RUN_MATRIX_STRATEGIES")
    if env_filter:
        keep = {s.strip() for s in env_filter.split(",")}
        strategies = [s for s in STRATEGIES if s[0] in keep]

    images = {}
    table_rows = []
    print(f"{'strategy':<12} {'backend':<8} {'first(ms)':>10} {'steady(ms)':>11} {'Mrays/s':>9}")
    for suffix, backend, sharded in strategies:
        # jnp's broadcast search needs chunking to bound its [chunk, N, 3]
        # intermediates; mxu additionally needs it for depth > 1 (the
        # per-bounce [R, N] feature products at full-frame R). The sweep
        # kernel keeps no [R, N] temporaries and runs unchunked.
        chunk = 262144 if (backend == "jnp"
                           or (backend == "mxu" and args.depth > 1)) else 0
        cfg = RenderConfig(backend=backend, ray_chunk=chunk,
                           depth=args.depth)

        def go(k=0):
            # k > 0 nudges the camera origin by k * 1e-6 scene units:
            # DISTINCT executable arguments (same shapes, no recompile),
            # so no dispatch-level result reuse can satisfy the call.
            c = cam if not k else dataclasses.replace(
                cam, origin=cam.origin + np.float32(k * 1e-6))
            if sharded:
                return render_sharded(scene, c, width, height, cfg, mesh)
            return render(scene, c, width, height, cfg)

        t0 = time.perf_counter()
        img = jax.block_until_ready(go())
        first = (time.perf_counter() - t0) * 1e3
        steady = float("inf")
        for k in (1, 2, 3):
            t0 = time.perf_counter()
            jax.block_until_ready(go(k))
            steady = min(steady, (time.perf_counter() - t0) * 1e3)
        mrays = width * height / (steady / 1e3) / 1e6
        print(f"{suffix:<12} {backend:<8} {first:>10.1f} {steady:>11.1f} {mrays:>9.2f}")
        table_rows.append((suffix, backend, first, steady, mrays))
        arr = np.asarray(img)
        images[suffix] = arr
        write_ppm(os.path.join(args.out, f"output{suffix}.ppm"), arr)

    # Cross-strategy golden comparison (same seed -> near-identical images;
    # borderline eps-window pixels may flip between backends).
    base_name = strategies[0][0]
    base = images[base_name]
    ok = True
    flips_by = {}
    for suffix, arr in images.items():
        if suffix == base_name:
            continue
        diff = np.abs(arr - base).max(-1)
        flips = float((diff > 1e-3).mean())
        flips_by[suffix] = flips
        status = "OK" if flips < 0.005 else "MISMATCH"
        ok &= flips < 0.005
        print(f"  {suffix:<10} vs {base_name}: {flips*100:.3f}% pixels differ -> {status}")
    golden_stats = None
    if args.golden:
        # Full-resolution golden comparison against the reference C++
        # binary's 6-run mean image (the de-facto golden of the
        # reference's scripts/run.sh:27-41 eyeball comparison). Same
        # protocol as tests/test_golden.py but at FULL resolution on the
        # chip: reference_cpp light mode (quirk-2 two-point sampling),
        # float-eps shadow back-off (the reference's self-shadow acne is
        # real signal), 4 seeds averaged vs the golden's 6-run average.
        data = np.load(args.golden)
        gold = data["image"].astype(np.float32) / 255.0
        gh, gw, _ = gold.shape
        acc = []
        t0 = time.perf_counter()
        for seed in range(4):
            gcfg = RenderConfig(light_mode="reference_cpp", seed=seed,
                                shadow_eps=1.1920929e-07)
            gimg = np.asarray(render(scene, cam, gw, gh, gcfg))
            acc.append(np.minimum(gimg, 1.0))
        golden_ms = (time.perf_counter() - t0) * 1e3
        mine = np.mean(acc, axis=0)

        def patches(a):
            h, w, _ = a.shape
            return a[: h - h % 8, : w - w % 8].reshape(
                h // 8, 8, w // 8, 8, 3).mean((1, 3))

        pd = np.abs(patches(gold) - patches(mine)).max(-1)
        px = np.abs(gold - mine).max(-1)
        golden_stats = {
            "golden": os.path.basename(args.golden),
            "size": f"{gw}x{gh}",
            "seeds_averaged": 4,
            "render_4seed_ms": round(golden_ms, 1),
            "mean_lum_delta": round(float(abs(mine.mean() - gold.mean())), 5),
            "mean_abs_diff": round(float(px.mean()), 5),
            "patch8_median": round(float(np.median(pd)), 5),
            "patch8_frac_lt_0.12": round(float((pd < 0.12).mean()), 5),
            "pixel_flip_frac_gt_0.1": round(float((px > 0.1).mean()), 5),
        }
        print("golden vs reference_cpp (full res):",
              " ".join(f"{k}={v}" for k, v in golden_stats.items()
                       if k not in ("golden", "size")))
        # The same thresholds tests/test_golden.py enforces downsampled.
        g_ok = (golden_stats["patch8_median"] < 0.03
                and golden_stats["patch8_frac_lt_0.12"] > 0.9
                and golden_stats["mean_lum_delta"] < 0.02)
        golden_stats["pass"] = bool(g_ok)
        ok &= g_ok

    if args.json:
        import json
        import platform

        rec = {
            "workload": {"scene": f"cornell_{args.scene}" if args.scene != "original"
                         else "cornell", "size": args.size, "eye": args.eye,
                         "look": args.look, "depth": args.depth},
            "backend_platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "host": platform.node(),
            "strategies": [
                {"strategy": s, "backend": b, "first_ms": round(f, 1),
                 "steady_ms": round(st, 1), "mrays_per_s": round(m, 2)}
                for s, b, f, st, m in table_rows
            ],
            "cross_check_flip_frac": flips_by,
            "all_match": ok,
        }
        if golden_stats is not None:
            rec["golden_vs_reference"] = golden_stats
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
