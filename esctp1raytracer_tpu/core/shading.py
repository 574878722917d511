"""Phong/Blinn shading with sampled area lights and shadow rays.

Reproduces the reference shading block (src/main.cpp:728-788 and its ISPC
mirror src/ispc/trace.ispc:130-268):

* geometric normal = normalize(cross(v1-v0, v2-v0)) (src/main.cpp:728-731),
  replaced by the barycentric smooth normal
  normalize(N1*u + N2*v + N0*(1-u-v)) when the mesh has normals (:733-738);
* per light *source*: one random face of that source, one random point
  P = v0 + (v1-v0)*r1 + (v2-v0)*r2 on it (parallelogram sampling, exactly
  the reference's two uniform draws, trace.ispc:193-201);
* shadow ray from hit = origin + dir*(t - eps) toward P, occluded if any
  primitive lies within len(P-hit) - eps (:756-773);
* contribution (ka*0.5 + ke)/L + (kd*max(d,0) + ks*dot(N,H)^Ns)/L with
  H = normalize((N+L)*2), added only when the light is visible AND d > 0 —
  the reference `continue`s out of BOTH terms otherwise (:769-788).

Deliberate divergences (SURVEY.md quirk register):
* light sampling uses the face's three *distinct* vertices — the corrected
  ISPC behavior (trace.ispc:187-201), not the degenerate C++ v0=v1=v2 bug
  (quirk 2, src/main.cpp:748-754);
* the hit point is computed once from the true hit t — not from the stale
  t the reference leaks between light iterations (quirks in
  src/main.cpp:763 and trace.ispc:234-237);
* randomness is deterministic `jax.random` keyed per (pixel, light, bounce)
  instead of a shared unsynchronized mt19937 (quirk 8, src/main.cpp:588).

Emissive spheres are not light sources (the reference samples only
triangle geometry); sphere materials still emit via their ke term.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from esctp1raytracer_tpu.core.intersect import HitRecord
from esctp1raytracer_tpu.scene.types import Scene
from esctp1raytracer_tpu.utils import rng

_TINY = 1e-12


def _normalize(v: jax.Array) -> jax.Array:
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), _TINY))


def surface_attributes(
    o: jax.Array,
    d: jax.Array,
    hit: HitRecord,
    scene: Scene,
    shadow_eps: float,
    trow: jax.Array = None,
) -> Tuple[jax.Array, jax.Array, dict]:
    """Gather per-ray surface data at the winning primitive.

    Returns (hit_point [R,3], normal [R,3], material dict of [R,...]).
    All values are zero-safe for missed rays (no NaNs leak into gradients
    through masked lanes).

    trow is the winner's packed_tri_table row [R, 32] when the caller
    already gathered it (closest_hit with_row=True): each jnp.take's VJP
    is a scatter-add over every ray, so the pipeline gathers once and
    shares the row.
    """
    safe_prim = jnp.maximum(hit.prim, 0)
    tris, sph = scene.triangles, scene.spheres

    if trow is None:
        from esctp1raytracer_tpu.core.intersect import packed_tri_table

        trow = jnp.take(packed_tri_table(tris), safe_prim, axis=0)  # [R, 32]
    tv0, tv1, tv2 = trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
    n0, n1, n2 = trow[:, 9:12], trow[:, 12:15], trow[:, 15:18]

    n_geom = _normalize(jnp.cross(tv1 - tv0, tv2 - tv0))
    u, v = hit.u[:, None], hit.v[:, None]
    n_smooth = _normalize(n1 * u + n2 * v + n0 * (1.0 - u - v))
    has_n = trow[:, 31:32] > 0.5
    n_tri = jnp.where(has_n, n_smooth, n_geom)

    # Reference back-off: hit = origin + dir * (t - eps) (src/main.cpp:763).
    t_safe = jnp.where(hit.hit, hit.t, 1.0)[:, None]
    hit_p = o + d * (t_safe - shadow_eps)

    # Sphere normal: sanitize the unselected branch completely. A plain
    # where() is not enough — the division VJP squares the denominator,
    # and max(radius, eps)**2 underflows to 0 in f32 for the padded
    # radius-0 spheres, turning the zero cotangent into 0/0 = NaN.
    is_s = hit.is_sphere[:, None]
    sphere_prim = jnp.where(hit.is_sphere, safe_prim, 0)
    sph_packed = jnp.concatenate(
        [sph.center, sph.radius[:, None], sph.ka, sph.kd, sph.ks, sph.ke,
         sph.ns[:, None]], axis=1)  # [M, 17]
    from esctp1raytracer_tpu.core.intersect import select_rows

    srow = select_rows(sph_packed, sphere_prim)  # [R, 17]
    center, radius = srow[:, 0:3], srow[:, 3]
    r_safe = jnp.where(hit.is_sphere, jnp.maximum(radius, 1e-6), 1.0)
    n_sph = (jnp.where(is_s, hit_p - center, 0.0)) / r_safe[:, None]

    normal = jnp.where(is_s, n_sph, n_tri)

    def pick(tri_vals, sph_vals):
        cond = is_s if tri_vals.ndim == 2 else hit.is_sphere
        return jnp.where(cond, sph_vals, tri_vals)

    mat = {
        "ka": pick(trow[:, 18:21], srow[:, 4:7]),
        "kd": pick(trow[:, 21:24], srow[:, 7:10]),
        "ks": pick(trow[:, 24:27], srow[:, 10:13]),
        "ke": pick(trow[:, 27:30], srow[:, 13:16]),
        "ns": pick(trow[:, 30], srow[:, 16]),
    }
    mask = hit.hit[:, None]
    hit_p = jnp.where(mask, hit_p, 0.0)
    normal = jnp.where(mask, normal, 0.0)
    return hit_p, normal, mat


def sample_lights(
    scene: Scene, seed: int, ray_ids: jax.Array, bounce: int = 0,
    mode: str = "area",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sample one point per (ray, light source).

    Returns (P [R, L, 3], light_tri [R, L] int32, num_lights L).

    mode="area" mirrors the corrected ISPC sampling: random face of the
    source, then the parallelogram point v0 + (v1-v0)r1 + (v2-v0)r2
    (src/ispc/trace.ispc:178-201).

    mode="reference_cpp" reproduces the C++ path's quirk 2 exactly
    (src/main.cpp:748-754): `faceID` indexes the de-indexed *corner* array,
    and v0=v1=v2 all alias that corner, so P degenerates to corner
    `faceID` of the light's first face — needed for pixel-level parity
    with the reference's golden output.ppm.

    Draws are counter-based on the global ray id (utils/rng.py), so
    sampling is invariant to chunking/sharding.
    """
    lights = scene.lights
    L = lights.num_lights
    num_rays = ray_ids.shape[0]
    if L == 0:
        return (jnp.zeros((num_rays, 0, 3), jnp.float32),
                jnp.zeros((num_rays, 0), jnp.int32), 0)

    # One vectorized draw per (ray, light): stream ids (bounce*1024+l)*4
    # exactly as the former per-light Python unroll, so renders are
    # bit-identical, but the light axis scales to many emissive sources.
    streams = (jnp.uint32(bounce * 1024)
               + jnp.arange(L, dtype=jnp.uint32)) * jnp.uint32(4)  # [L]
    rid = ray_ids[:, None]
    face = rng.randint(seed, rid, streams, lights.face_count[None, :])  # [R, L]
    r1 = rng.uniform01(seed, rid, streams + jnp.uint32(1))[..., None]
    r2 = rng.uniform01(seed, rid, streams + jnp.uint32(2))[..., None]

    # tri_idx [L, F]; want [R, L] = tri_idx[l, face[r, l]].
    tri = jnp.take_along_axis(lights.tri_idx[None, :, :], face[:, :, None], axis=2)
    tri = tri[:, :, 0]

    if mode == "reference_cpp":
        # P = light.vertex[faceID]: `vertex` is the de-indexed corner array
        # (3 records per face, src/scene/sceneloader.cpp:78-97), so faceID
        # in [0, F) addresses corner faceID % 3 of face faceID // 3. r1/r2
        # are drawn but multiply zero vectors in the reference, so unused.
        src_tri = jnp.take_along_axis(
            lights.tri_idx[None, :, :], (face // 3)[:, :, None], axis=2
        )[:, :, 0]  # [R, L]
        c0 = jnp.take(scene.triangles.v0, src_tri, axis=0)  # [R, L, 3]
        c1 = jnp.take(scene.triangles.v1, src_tri, axis=0)
        c2 = jnp.take(scene.triangles.v2, src_tri, axis=0)
        corner = (face % 3)[:, :, None]
        p = jnp.where(corner == 0, c0, jnp.where(corner == 1, c1, c2))
        return p, tri, L

    light_packed = jnp.concatenate(
        [scene.triangles.v0, scene.triangles.v1, scene.triangles.v2], axis=1)
    F = lights.max_faces
    if L * F <= 16:
        # Small light tables: gather the [L, F, 9] corner table once (a
        # trivial L*F-row scatter in the VJP) and pick each ray's face by
        # a static select chain. The direct [R, L]-indexed gather's VJP
        # is a ~25-30 ms scatter-add of 2M rows into the full triangle
        # table; the selects' VJP is F masked reductions instead.
        lc = jnp.take(light_packed, lights.tri_idx, axis=0)  # [L, F, 9]
        rows = jnp.zeros(face.shape + (9,), jnp.float32)  # [R, L, 9]
        for f in range(F):
            rows = jnp.where((face == f)[..., None], lc[None, :, f, :], rows)
    else:
        rows = jnp.take(light_packed, tri, axis=0)  # [R, L, 9]
    v0, v1, v2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    p = v0 + (v1 - v0) * r1 + (v2 - v0) * r2
    return p, tri, L


def shade(
    o: jax.Array,
    d: jax.Array,
    hit: HitRecord,
    scene: Scene,
    seed: int,
    ray_ids: jax.Array,
    occlusion_fn: Callable[[jax.Array, jax.Array, jax.Array], jax.Array],
    shadow_eps: float = 1e-4,
    bounce: int = 0,
    light_mode: str = "area",
    trow: jax.Array = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Shade one wavefront of rays against all light sources.

    occlusion_fn(origins [M,3], dirs [M,3], t_limit [M]) -> occluded [M] bool.
    Returns (color [R,3], hit_point [R,3], normal [R,3], ks [R,3]) — the
    extras feed the reflection bounce in render.py. trow: see
    surface_attributes.
    """
    r = o.shape[0]
    hit_p, normal, mat = surface_attributes(o, d, hit, scene, shadow_eps,
                                            trow=trow)

    p_light, _, num_l = sample_lights(scene, seed, ray_ids, bounce, light_mode)
    if num_l == 0:
        return jnp.zeros((r, 3), jnp.float32), hit_p, normal, mat["ks"]

    l_vec = p_light - hit_p[:, None, :]  # [R, L, 3]
    dist = jnp.sqrt(jnp.maximum(jnp.sum(l_vec * l_vec, axis=-1), _TINY))  # [R, L]
    l_dir = l_vec / dist[..., None]
    d_nl = jnp.sum(normal[:, None, :] * l_dir, axis=-1)  # [R, L]
    # Back-facing surface points (d_nl <= 0) are unlit regardless of
    # occlusion (`visible` below), so their shadow query is dead work; a
    # negative t_limit makes the culling backends drop the whole ray.
    t_limit = jnp.where(d_nl > 0.0, dist - shadow_eps, -1.0)

    # Missed primary rays contribute nothing, but their shadow queries
    # would still traverse the scene. Park their origin far outside every
    # bounding box so the culling backends drop them for free (the result
    # is masked by `visible` regardless).
    far = jnp.asarray([3e7, 3e7, 3e7], hit_p.dtype)
    occl_origin = jnp.where(hit.hit[:, None], hit_p, far)

    flat = lambda a: a.reshape((r * num_l,) + a.shape[2:])
    occluded = occlusion_fn(
        flat(jnp.broadcast_to(occl_origin[:, None, :], l_vec.shape)),
        flat(l_dir),
        flat(t_limit),
    ).reshape(r, num_l)

    h_vec = _normalize((normal[:, None, :] + l_dir) * 2.0)
    spec_dot = jnp.maximum(jnp.sum(normal[:, None, :] * h_vec, axis=-1), 0.0)
    # pow with a floor: grads stay finite at grazing angles; the value is
    # only used where d_nl > 0, which implies spec_dot > 0.
    spec = jnp.power(jnp.maximum(spec_dot, _TINY), mat["ns"][:, None])

    inv_l = jnp.float32(1.0 / num_l)
    base = (mat["ka"] * 0.5 + mat["ke"])[:, None, :] * inv_l  # [R, 1, 3]
    lit = (
        mat["kd"][:, None, :] * d_nl[..., None]
        + mat["ks"][:, None, :] * spec[..., None]
    ) * inv_l
    visible = hit.hit[:, None] & (~occluded) & (d_nl > 0.0)
    color = jnp.sum(jnp.where(visible[..., None], base + lit, 0.0), axis=1)
    return color, hit_p, normal, mat["ks"]
