"""SoA 3-vectors: three 1-D component arrays instead of one (N, 3) array.

An (N, 3) f32 array puts the 3 on its minor dimension, so elementwise
math on packed vectors strides over it unless XLA re-lays it out.
Carrying vectors as three (N,) components keeps every op a contiguous
1-D stream and lets the
bounce-loop carry stay flat (ops/integrator.py _split3 — this module is
that treatment promoted to the whole shading path).

The reference's GLSL vec3 operators map 1:1 (rendering/language.glsl).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (component-wise; scalars broadcast) --------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def vec3(x, y, z) -> Vec3:
    return Vec3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def splat(s) -> Vec3:
    """Scalar (array) -> Vec3 with all components equal."""
    s = jnp.asarray(s)
    return Vec3(s, s, s)


def from_array(v) -> Vec3:
    """(..., 3) -> Vec3 of (...,) components."""
    return Vec3(v[..., 0], v[..., 1], v[..., 2])


def to_array(a: Vec3) -> jnp.ndarray:
    """Vec3 -> (..., 3). Only at API boundaries — re-packing mid-chain
    reintroduces the (N, 3) layout this module exists to avoid."""
    return jnp.stack(jnp.broadcast_arrays(a.x, a.y, a.z), axis=-1)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3):
    return jnp.sqrt(dot(a, a))


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / jnp.maximum(length(a), eps)
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def where(m, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select by a scalar mask (NOT per-component masks)."""
    return Vec3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z))


def vabs(a: Vec3) -> Vec3:
    return Vec3(jnp.abs(a.x), jnp.abs(a.y), jnp.abs(a.z))


def vmax(a: Vec3, b) -> Vec3:
    if isinstance(b, Vec3):
        return Vec3(
            jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z)
        )
    return Vec3(jnp.maximum(a.x, b), jnp.maximum(a.y, b), jnp.maximum(a.z, b))


def max_component(a: Vec3):
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def luminance(c: Vec3):
    """Rec.709 luminance (rendering/util.glsl luminance)."""
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect(i, n) = i - 2*dot(n, i)*n."""
    d2 = 2.0 * dot(n, i)
    return Vec3(i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z)


def refract(i: Vec3, n: Vec3, eta):
    """GLSL refract; returns (r, tir) with r = 0 on total internal
    reflection."""
    n_dot_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    c = eta * n_dot_i + jnp.sqrt(jnp.maximum(k, 0.0))
    r = Vec3(eta * i.x - c * n.x, eta * i.y - c * n.y, eta * i.z - c * n.z)
    zero = jnp.zeros_like(r.x)
    return where(tir, Vec3(zero, zero, zero), r), tir
