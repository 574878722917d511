#!/usr/bin/env python
"""Smoke run of the renderer's main path on one GPU, in one process.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded phase only

Phases on one card, each printed as one JSON line with its compile
seconds, warm steady-state milliseconds (host clock around
`block_until_ready`), resolved backend and `peak_bytes_in_use`:

* the sweep kernel against the plain reference `argmin_hit(use_mxu=False)`
  at the flagship's full width (winners, t, occlusion), and its times
  beside XLA's `_scan_blocks` in the `jnp` and `mxu` forms, at the
  flagship and at BASELINE config 5 (brute and culled entries);
* the flagship (bench.py's ~10.2k-triangle scene, 1920x1080, depth 1):
  forward and forward+backward with `auto` against `jnp`, images and
  gradients compared;
* Cornell at 1024x768 and the mixed scene at 1920x1080 depth 4, images
  compared with `jnp`;
* inverse rendering: 5 Adam steps of `fit_scene` on the mixed scene at
  512x512 with a checkpoint and one resume;
* the CLI, in process: `--scene mixed --depth 4 --ispc -w 1920,1080`.

`--four` runs `render_sharded` and `train_step_sharded` at flagship size
on a 4x1 and a 2x2 ('rays', 'prims') mesh and compares both with the
same program on device 0 alone.

Exits non-zero, printing no result, when JAX finds no GPU, when a phase
raises or misses its tolerance, or when `auto` does not resolve to the
sweep kernel. The last line is the result JSON.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")

# Image agreement (quirk-16 eps band plus GPU FMA contraction): fewer than
# this share of pixels may differ by more than PIXEL_TOL in any channel.
PIXEL_TOL = 1e-3
PIXEL_SHARE = 0.005
# Search agreement at full width, as the CPU kernel tests hold it. The t
# of a float32 plane hit is ill-conditioned at grazing incidence: an ulp
# of the ray moves it by ~ulp / |cos| (cos = angle between ray and
# normal), so two formulations are held to T_RTOL after that factor.
WINNER_SHARE = 0.995
T_RTOL = 2e-6
# Gradients over the pixels whose primary winners agree: the relative L2
# error of each parameter leaf stays under GRAD_RTOL. Reflection bounces
# add winner flips the primary mask cannot see (reflected rays graze
# more often), so deeper renders are held to GRAD_RTOL_DEEP.
GRAD_RTOL = 1e-3
GRAD_RTOL_DEEP = 1e-2


def emit(phase: str, **fields) -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    fields["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(fn, *args, reps: int = 5):
    """(compile-and-first-call seconds, median warm ms, last output)."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)) * 1e3, out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def pixel_share(a, b) -> float:
    import numpy as np

    diff = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    return float((diff > PIXEL_TOL).mean())


def flagship():
    """bench.py's scene and camera rays."""
    import jax.numpy as jnp

    from esctp1raytracer_tpu import Camera
    from esctp1raytracer_tpu.scene import builders

    meshes = [
        builders.icosphere_mesh(subdivisions=4, radius=1.0,
                                center=(-1.3, 1.0, 0.0)),
        builders.icosphere_mesh(subdivisions=4, radius=1.0,
                                center=(1.3, 1.0, 0.0), smooth=False),
        builders._ground_plane(),
        builders._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]
    scene = builders.scene_from_mesh(meshes)
    cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0,
                         aspect=1920 / 1080)
    o, d = cam.ray_grid(1920, 1080)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    return scene, cam, o, d, ids


def shadow_wavefront(o, d, t, hit, center, half, seed=0):
    """Shadow rays as shading builds them: from the backed-off hit point
    to a random interior point of the scene's square area light at
    `center`, with the ceiling just short of the light."""
    import jax
    import jax.numpy as jnp

    k1 = jax.random.PRNGKey(seed)
    r = o.shape[0]
    jitter = jax.random.uniform(k1, (r, 2), minval=-0.95 * half,
                                maxval=0.95 * half)
    light = jnp.stack([center[0] + jitter[:, 0], jnp.full((r,), center[1]),
                       center[2] + jitter[:, 1]], axis=1)
    p = o + d * (t - 1e-4)[:, None]
    to = light - p
    dist = jnp.sqrt(jnp.sum(to * to, axis=-1))
    return p, to / dist[:, None], jnp.where(hit, dist - 1e-4, -1.0)


def phase_kernel(scene, o, d):
    """Sweep kernel against the reference and against XLA (§ kernel)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from esctp1raytracer_tpu import Camera
    from esctp1raytracer_tpu.core.intersect import EPS, _scan_blocks, argmin_hit
    from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch
    from esctp1raytracer_tpu.scene import builders

    eps = jnp.float32(EPS)
    ref = jax.jit(lambda sc, o, d: argmin_hit(o, d, sc, eps, use_mxu=False))
    c, ms, (t_ref, p_ref, _) = timed(ref, scene, o, d, reps=3)
    so, sd, stl = shadow_wavefront(o, d, t_ref, p_ref >= 0, (0.0, 6.0, 2.0),
                                   1.5)
    occ_ref = jax.jit(lambda sc, o, d, tl: argmin_hit(
        o, d, sc, eps, use_mxu=False, t_limit=tl)[0] < tl)(scene, so, sd, stl)
    occ_ref = np.asarray(occ_ref)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    tri = scene.triangles
    nrm = np.cross(np.asarray(tri.v1 - tri.v0), np.asarray(tri.v2 - tri.v0))
    nrm = nrm[np.maximum(p_ref, 0)]
    cosine = np.abs(np.sum(nrm * np.asarray(d), -1)) / np.maximum(
        np.linalg.norm(nrm, axis=-1), 1e-30)
    rows = []
    for name, search in (("sweep", SweepSearch(culled=False)),
                         ("sweep_culled", SweepSearch(culled=True))):
        f = jax.jit(lambda tr, o, d, s=search: s(o, d, tr, eps))
        c1, ms1, (t, p) = timed(f, scene.triangles, o, d)
        g = jax.jit(lambda tr, o, d, tl, s=search: s.occlusion(o, d, tl, tr, eps))
        c2, ms2, occ = timed(g, scene.triangles, so, sd, stl)
        t, p, occ = np.asarray(t), np.asarray(p), np.asarray(occ)
        agree = p == p_ref
        both = agree & (p_ref >= 0)
        rel = np.abs(t[both] - t_ref[both]) / np.abs(t_ref[both])
        scaled = rel * cosine[both]
        worst = int(np.flatnonzero(both)[np.argmax(rel)])
        row = dict(search=name, closest_ms=ms1, any_ms=ms2,
                   compile_s=c1 + c2, winner_agree=float(agree.mean()),
                   t_maxrel=float(rel.max()),
                   t_over_rtol=int((rel > T_RTOL).sum()),
                   t_max_rel_times_cos=float(scaled.max()),
                   worst=dict(ray=worst, t_ref=float(t_ref[worst]),
                              t=float(t[worst]), prim=int(p_ref[worst]),
                              cos=float(cosine[worst])),
                   occl_agree=float((occ == occ_ref).mean()))
        rows.append(row)
        emit("kernel_numerics_flagship", **row)
        check(row["winner_agree"] >= WINNER_SHARE, f"{name} winners")
        check(row["t_max_rel_times_cos"] <= T_RTOL, f"{name} t rtol")
        check(row["occl_agree"] >= WINNER_SHARE, f"{name} occlusion")
    for use_mxu, name in ((False, "xla_jnp"), (True, "xla_mxu")):
        f = jax.jit(lambda tr, o, d, m=use_mxu: _scan_blocks(
            o, d, tr, eps, 512, m))
        c1, ms1, _ = timed(f, scene.triangles, o, d, reps=3)
        g = jax.jit(lambda tr, o, d, tl, m=use_mxu: _scan_blocks(
            o, d, tr, eps, 512, m)[0] < tl)
        c2, ms2, _ = timed(g, scene.triangles, so, sd, stl, reps=3)
        emit("kernel_vs_xla_flagship", search=name, closest_ms=ms1,
             any_ms=ms2, compile_s=c1 + c2)

    # Small tables: where the culled entry's pre-pass may not pay.
    small = (
        ("cornell_1024x768", builders.cornell_box(),
         Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=4 / 3),
         1024, 768, (0.0, 1.979, -0.03), 0.18),
        ("mixed_1920x1080", builders.mixed_scene(),
         Camera.look_at((0, 2.5, 7), (0, 1, 0), vfov=60.0, aspect=16 / 9),
         1920, 1080, (0.0, 6.999, 1.0), 2.0),
    )
    for label, sc, cm, w, h, lc, lh in small:
        os_, ds_ = cm.ray_grid(w, h)
        os_, ds_ = os_.reshape(-1, 3), ds_.reshape(-1, 3)
        for name, search in (("sweep", SweepSearch(culled=False)),
                             ("sweep_culled", SweepSearch(culled=True))):
            f = jax.jit(lambda tr, o, d, s=search: s(o, d, tr, eps))
            c1, ms1, (ts, ps) = timed(f, sc.triangles, os_, ds_)
            sso, ssd, sstl = shadow_wavefront(os_, ds_, ts, ps >= 0, lc, lh)
            g = jax.jit(lambda tr, o, d, tl, s=search: s.occlusion(
                o, d, tl, tr, eps))
            c2, ms2, _ = timed(g, sc.triangles, sso, ssd, sstl)
            emit("kernel_small_scenes", scene=label, search=name,
                 tris=sc.triangles.capacity, closest_ms=ms1, any_ms=ms2,
                 compile_s=c1 + c2)

    # BASELINE config 5: 100k-triangle soup at 3840x2160.
    big = builders.random_scene(100_000)
    cam5 = Camera.look_at((0, 18, 45), (0, 1, 0), vfov=60.0,
                          aspect=3840 / 2160)
    o5, d5 = cam5.ray_grid(3840, 2160)
    o5, d5 = o5.reshape(-1, 3), d5.reshape(-1, 3)
    ref5 = None
    for name, search in (("sweep_culled", SweepSearch(culled=True)),
                         ("sweep", SweepSearch(culled=False))):
        f = jax.jit(lambda tr, o, d, s=search: s(o, d, tr, eps))
        c1, ms1, (t5, p5) = timed(f, big.triangles, o5, d5, reps=2)
        if ref5 is None:
            ref5 = p5
            so5, sd5, stl5 = shadow_wavefront(o5, d5, t5, p5 >= 0,
                                              (0.0, 30.0, 0.0), 5.0)
        g = jax.jit(lambda tr, o, d, tl, s=search: s.occlusion(o, d, tl, tr, eps))
        c2, ms2, _ = timed(g, big.triangles, so5, sd5, stl5, reps=2)
        agree = float(jnp.mean(p5 == ref5))
        emit("kernel_config5", search=name, rays=int(o5.shape[0]),
             closest_ms=ms1, any_ms=ms2, compile_s=c1 + c2,
             winner_agree_with_culled=agree)
        check(agree >= WINNER_SHARE, f"config 5 {name} winners")
    # XLA on an eighth of the rays (memory and time), scaled by 8.
    sub = slice(0, o5.shape[0] // 8)
    f = jax.jit(lambda tr, o, d: _scan_blocks(o, d, tr, eps, 512, False))
    c1, ms1, _ = timed(f, big.triangles, o5[sub], d5[sub], reps=2)
    emit("kernel_config5", search="xla_jnp", rays=int(o5[sub].shape[0]),
         closest_ms=ms1, closest_ms_scaled_to_frame=ms1 * 8, compile_s=c1)
    return rows


def primary_agreement(scene, cam, w, h):
    """[h, w, 1] mask of pixels whose camera ray gets the same winner from
    the sweep kernel and from the plain reference."""
    import jax
    import jax.numpy as jnp

    from esctp1raytracer_tpu.core.intersect import EPS, argmin_hit
    from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch

    @jax.jit
    def agree(sc, cm):
        o, d = cm.ray_grid(w, h)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        eps = jnp.float32(EPS)
        _, p_k, _ = argmin_hit(o, d, sc, eps, tri_search=SweepSearch())
        _, p_j, _ = argmin_hit(o, d, sc, eps, use_mxu=False)
        return (p_k == p_j).reshape(h, w, 1)

    return agree(scene, cam)


def render_pair(scene, cam, w, h, depth, grad: bool):
    """auto against jnp: times, images and, with `grad`, the gradients of
    sum(image^2) over the pixels whose primary winners agree (the search
    is under stop_gradient, so only eps-band flips can tell them apart)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from esctp1raytracer_tpu import RenderConfig, render
    from esctp1raytracer_tpu.core.render import resolve_backend
    from esctp1raytracer_tpu.parallel.sharding import float_params, merge_params

    mask = primary_agreement(scene, cam, w, h) if grad else None
    out = {}
    for backend in ("auto", "jnp"):
        cfg = RenderConfig(backend=backend, depth=depth)
        resolved = resolve_backend(cfg)
        if backend == "auto":
            check(resolved == "sweep", f"auto resolved to {resolved}")
        fwd = jax.jit(lambda sc, cm, c=cfg: render(sc, cm, w, h, c))
        c, ms, img = timed(fwd, scene, cam)
        rec = dict(backend=backend, resolved=resolved, forward_compile_s=c,
                   forward_ms=ms)
        grads = None
        if grad:
            def loss(ps, cm, c=cfg):
                img = render(merge_params(scene, ps), cm, w, h, c)
                return jnp.sum(jnp.where(mask, img * img, 0.0))

            g = jax.jit(jax.grad(loss))
            cg, msg, grads = timed(g, float_params(scene), cam, reps=3)
            rec.update(fwd_bwd_compile_s=cg, fwd_bwd_ms=msg)
        out[backend] = (rec, np.asarray(img), grads)
    share = pixel_share(out["auto"][1], out["jnp"][1])
    check(np.isfinite(out["auto"][1]).all(), "non-finite image")
    result = dict(auto=out["auto"][0], jnp=out["jnp"][0],
                  pixels_over_tol=share)
    check(share < PIXEL_SHARE, f"image agreement {share}")
    if grad:
        errs = {}
        names = [jax.tree_util.keystr(path) for path, leaf
                 in jax.tree_util.tree_flatten_with_path(scene)[0]
                 if jnp.issubdtype(leaf.dtype, jnp.floating)]
        for name, ga, gj in zip(names, out["auto"][2], out["jnp"][2]):
            ga, gj = np.asarray(ga), np.asarray(gj)
            check(np.isfinite(ga).all(), "non-finite gradient")
            nj = np.linalg.norm(gj)
            err = np.linalg.norm(ga - gj)
            errs[name] = float(err / nj) if nj > 0 else float(err)
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        tol = GRAD_RTOL if depth == 1 else GRAD_RTOL_DEEP
        result["primary_winners_agree"] = float(np.asarray(mask).mean())
        result["grad_rel_l2_worst_leaves"] = {k: errs[k] for k in worst}
        result["grad_tolerance"] = tol
        check(errs[worst[0]] <= tol, f"gradient agreement {errs[worst[0]]}")
    return result, out["auto"][1]


def phase_scenes(scene, cam):
    from esctp1raytracer_tpu import Camera, cornell_box, write_ppm
    from esctp1raytracer_tpu.scene import builders

    res, img = render_pair(scene, cam, 1920, 1080, 1, grad=True)
    emit("flagship_1080p", **res)
    write_ppm(os.path.join(OUT, "flagship.ppm"), img)

    ccam = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0,
                          aspect=1024 / 768)
    res, img = render_pair(cornell_box(), ccam, 1024, 768, 1, grad=False)
    emit("cornell_1024x768", **res)
    write_ppm(os.path.join(OUT, "cornell.ppm"), img)

    mcam = Camera.look_at((0, 2.5, 7), (0, 1, 0), vfov=60.0,
                          aspect=1920 / 1080)
    res, img = render_pair(builders.mixed_scene(), mcam, 1920, 1080, 4,
                           grad=True)
    emit("mixed_1080p_depth4", **res)


def phase_inverse():
    """fit_scene: 3 steps, checkpoint, resume for 2 more."""
    import dataclasses

    import numpy as np

    from esctp1raytracer_tpu import Camera, RenderConfig, render
    from esctp1raytracer_tpu.grad import fit_scene
    from esctp1raytracer_tpu.scene import builders

    true_scene = builders.mixed_scene()
    cam = Camera.look_at((0, 2.5, 7), (0, 1, 0), vfov=60.0, aspect=1.0)
    cfg = RenderConfig(backend="auto", depth=4)
    target = render(true_scene, cam, 512, 512, cfg)
    sp = true_scene.spheres
    start = dataclasses.replace(
        true_scene, spheres=dataclasses.replace(sp, kd=sp.kd * 0.5,
                                                ks=sp.ks * 0.5))
    ckpt = os.path.join(OUT, "fit.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    keep = lambda i, p: p is start.spheres.kd or p is start.spheres.ks  # noqa: E731
    t0 = time.perf_counter()
    first = fit_scene(start, target, cam, steps=3, lr=0.05, cfg=cfg,
                      param_filter=keep, checkpoint_path=ckpt,
                      checkpoint_every=3, log_every=0)
    t1 = time.perf_counter()
    resumed = fit_scene(start, target, cam, steps=5, lr=0.05, cfg=cfg,
                        param_filter=keep, checkpoint_path=ckpt,
                        checkpoint_every=3, log_every=0)
    t2 = time.perf_counter()
    losses = first.losses + resumed.losses
    emit("inverse_rendering", losses=losses, steps_before_resume=first.steps,
         steps_after_resume=resumed.steps, first_run_s=t1 - t0,
         resumed_run_s=t2 - t1)
    check(len(losses) == 5 and resumed.steps == 2, "resume did not happen")
    check(bool(np.isfinite(losses).all()), "non-finite loss")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "loss did not go down at every step")


def phase_cli():
    from esctp1raytracer_tpu import cli
    from esctp1raytracer_tpu.io.ppm import read_ppm

    path = os.path.join(OUT, "cli_mixed.ppm")
    t0 = time.perf_counter()
    rc = cli.main(["--scene", "mixed", "--depth", "4", "--ispc",
                   "-w", "1920,1080", "-o", path])
    emit("cli", rc=rc, seconds=time.perf_counter() - t0)
    check(rc == 0, f"cli exit {rc}")
    check(read_ppm(path).shape == (1080, 1920, 3), "cli image shape")


def phase_four():
    """The sharded paths on four cards against device 0 alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from esctp1raytracer_tpu import RenderConfig
    from esctp1raytracer_tpu.parallel import (
        make_mesh, render_sharded, train_step_sharded)
    from esctp1raytracer_tpu.parallel.sharding import float_params

    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")
    scene, cam, *_ = flagship()
    cfg = RenderConfig(backend="auto")
    one = make_mesh(devices[:1])
    c, ms, ref_img = timed(
        lambda: render_sharded(scene, cam, 1920, 1080, cfg, one), reps=3)
    ref_img = np.asarray(ref_img)
    target = jnp.asarray(ref_img * 0.9)
    step = lambda m: train_step_sharded(scene, target, cam, 1e-3, cfg, m)  # noqa: E731
    cs, mss, (ref_scene, ref_loss) = timed(step, one, reps=2)
    emit("sharded_one_card", render_ms=ms, render_compile_s=c,
         train_step_ms=mss, train_step_compile_s=cs, loss=float(ref_loss))
    start = [np.asarray(p) for p in float_params(scene)]
    ref_update = [np.asarray(p) - p0
                  for p, p0 in zip(float_params(ref_scene), start)]
    for rays, prims in ((4, 1), (2, 2)):
        mesh = make_mesh(devices, rays=rays, prims=prims)
        c, ms, img = timed(
            lambda: render_sharded(scene, cam, 1920, 1080, cfg, mesh), reps=3)
        share = pixel_share(img, ref_img)
        cs, mss, (new_scene, loss) = timed(step, mesh, reps=2)
        rel_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        # The SGD update (lr * grad) of each leaf against device 0's.
        errs = []
        for a, p0, b in zip(float_params(new_scene), start, ref_update):
            a = np.asarray(a) - p0
            nb = np.linalg.norm(b)
            errs.append(float(np.linalg.norm(a - b) / nb) if nb else
                        float(np.linalg.norm(a - b)))
        emit("sharded_four_cards", mesh=f"{rays}x{prims}", render_ms=ms,
             render_compile_s=c, train_step_ms=mss, train_step_compile_s=cs,
             pixels_over_tol=share, loss_rel_err=rel_loss,
             update_max_rel_l2=max(errs))
        check(share < PIXEL_SHARE, f"{rays}x{prims} image agreement {share}")
        check(rel_loss < 1e-4, f"{rays}x{prims} loss {rel_loss}")
        check(max(errs) < GRAD_RTOL, f"{rays}x{prims} parameter update")


def main(argv) -> int:
    four = "--four" in argv
    sys.path.insert(0, ROOT)
    try:
        import esctp1raytracer_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 1
    from esctp1raytracer_tpu.utils.compile_cache import enable_compile_cache
    from esctp1raytracer_tpu.utils.device import card_name_and_power_limit

    print(f"card: {card_name_and_power_limit()}", flush=True)

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    if four:
        phase_four()
        count = 4
    else:
        scene, cam, o, d, _ = flagship()
        phase_kernel(scene, o, d)
        phase_scenes(scene, cam)
        phase_inverse()
        phase_cli()
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
