"""Pinhole look-at camera.

Same model as the reference camera (src/scene/camera.h:14-41): vfov is the
top-to-bottom field of view in degrees, the basis is (u, v, w) with
w = normalize(lookfrom - lookat), and a ray through image fraction (s, t) is
normalize(lower_left_corner + s*horizontal + t*vertical - origin). Image
fractions are s = w/(W-1), t = h/(H-1) exactly as the pixel loop computes
them (src/main.cpp:709-711). Instead of one get_ray call per pixel we emit
the whole [H, W] ray grid as two arrays — the unit of work is the full
ray wavefront, not the pixel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@jax.tree_util.register_dataclass
@dataclass
class Camera:
    origin: jax.Array  # [3]
    lower_left_corner: jax.Array  # [3]
    horizontal: jax.Array  # [3]
    vertical: jax.Array  # [3]

    @staticmethod
    def look_at(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov: float = 60.0,
        aspect: float = 4.0 / 3.0,
    ) -> "Camera":
        lookfrom = jnp.asarray(lookfrom, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)
        theta = vfov * np.pi / 180.0
        half_height = jnp.tan(theta / 2.0)
        half_width = aspect * half_height
        w = _normalize(lookfrom - lookat)
        u = _normalize(jnp.cross(vup, w))
        v = jnp.cross(w, u)
        origin = lookfrom
        lower_left_corner = origin - u * half_width - v * half_height - w
        return Camera(
            origin=origin,
            lower_left_corner=lower_left_corner,
            horizontal=u * 2.0 * half_width,
            vertical=v * 2.0 * half_height,
        )

    def get_ray(self, s: jax.Array, t: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Rays through image fractions s, t (arrays broadcast together).

        Returns (origins, dirs) with dirs normalized, shapes [..., 3].
        """
        s = jnp.asarray(s, jnp.float32)[..., None]
        t = jnp.asarray(t, jnp.float32)[..., None]
        direction = (
            self.lower_left_corner + self.horizontal * s + self.vertical * t - self.origin
        )
        direction = _normalize(direction)
        origin = jnp.broadcast_to(self.origin, direction.shape)
        return origin, direction

    def ray_grid(self, width: int, height: int) -> Tuple[jax.Array, jax.Array]:
        """All camera rays for a width×height image, shape [H, W, 3] each.

        Row h of the output corresponds to image row h in the reference's
        image[h*W + w] layout (the PPM writer flips rows at write time,
        src/main.cpp:661).
        """
        ws = jnp.arange(width, dtype=jnp.float32) / jnp.float32(width - 1)
        hs = jnp.arange(height, dtype=jnp.float32) / jnp.float32(height - 1)
        s = jnp.broadcast_to(ws[None, :], (height, width))
        t = jnp.broadcast_to(hs[:, None], (height, width))
        return self.get_ray(s, t)
