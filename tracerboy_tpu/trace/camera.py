"""Camera model and primary ray generation.

Reimplements the reference's thin-lens pinhole model: the camera is a lens
rectangle of height `lens_height` centered at `position` spanned by
right/up, with the ray origin at a focal point `focal_distance` *behind*
the lens along the view direction (TracerBoy/kernel.glsl:1788-1803
GetLensPosition, 1805-1905 PathTrace; parameters extracted from the pbrt
camera frame in TracerBoy/TracerBoy.cpp:1243-1272: lens_height = 2|up|,
focal_distance = (lens_height/2) / tan(fov/2)).

Rays broadcast over flat pixel-id pools; depth of field applies a
concentric aperture jitter and refocuses through the focus plane
(kernel.glsl:1890-1903).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from tracerboy_tpu.core.mathutil import normalize


@dataclass
class Camera:
    """Host-side camera description (numpy; becomes a traced pytree)."""

    position: np.ndarray     # (3,)
    look_at: np.ndarray      # (3,)
    up: np.ndarray           # (3,) unit
    right: np.ndarray        # (3,) unit
    lens_height: float
    focal_distance: float

    @staticmethod
    def from_pbrt(camera_ir, width: int, height: int) -> "Camera":
        """Build from a parsed pbrt camera (camera_to_world + fov).

        Mirrors the extraction in TracerBoy.cpp:1243-1272: the lens height
        comes from the frame's up-vector length, the focal distance from
        the vertical FOV, and the eye point is pushed back so that rays
        through the lens rectangle reproduce the pbrt view frustum.
        """
        c2w = camera_ir.camera_to_world
        right = c2w[:3, 0].copy()
        up = c2w[:3, 1].copy()
        view = c2w[:3, 2].copy()
        pos = c2w[:3, 3].copy()
        # pbrt's camera space is left-handed looking down +z; normalize the
        # frame but keep handedness as given.
        lens_height = 2.0 * float(np.linalg.norm(up))
        up = up / np.linalg.norm(up)
        right = right / np.linalg.norm(right)
        view = view / np.linalg.norm(view)
        fov_rad = np.deg2rad(camera_ir.fov)
        focal_distance = (lens_height / 2.0) / np.tan(fov_rad / 2.0)
        position = pos + (focal_distance + 0.01) * view
        look_at = position + view
        return Camera(
            position=position.astype(np.float32),
            look_at=look_at.astype(np.float32),
            up=up.astype(np.float32),
            right=right.astype(np.float32),
            lens_height=float(lens_height),
            focal_distance=float(focal_distance),
        )

    def as_pytree(self) -> dict:
        return dict(
            position=jnp.asarray(self.position),
            look_at=jnp.asarray(self.look_at),
            up=jnp.asarray(self.up),
            right=jnp.asarray(self.right),
            lens_height=jnp.float32(self.lens_height),
            focal_distance=jnp.float32(self.focal_distance),
        )


def generate_primary_rays(
    cam: dict,
    width: int,
    height: int,
    pixel_ids: jnp.ndarray,
    jitter: jnp.ndarray,
    dof_focus_distance=0.0,
    dof_aperture_width=0.0,
    dof_jitter: jnp.ndarray | None = None,
    filter_width: float = 1.0,
):
    """Primary rays for flat pixel ids.

    cam: Camera.as_pytree() dict (traced).
    pixel_ids: (N,) int32 flat index = y * width + x, row 0 = top.
    jitter: (N, 2) in [0,1)^2 AA jitter within the pixel.
    Returns (origin (N,3), direction (N,3)).
    """
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)

    offset = (jitter - 0.5) * filter_width
    u = (px + 0.5 + offset[..., 0]) / width
    v = (py + 0.5 + offset[..., 1]) / height
    # Image row 0 is the top: flip v to map to +up on the lens.
    v = 1.0 - v

    aspect = width / height
    pos = cam["position"]
    forward = normalize(cam["look_at"] - pos)
    lens_w = cam["lens_height"] * aspect
    lens_point = (
        pos
        + cam["right"] * ((u * 2.0 - 1.0) * lens_w / 2.0)[..., None]
        + cam["up"] * ((v * 2.0 - 1.0) * cam["lens_height"] / 2.0)[..., None]
    )
    focal_point = pos - cam["focal_distance"] * forward
    origin = jnp.broadcast_to(focal_point, lens_point.shape)
    direction = normalize(lens_point - focal_point)

    if dof_jitter is not None:
        # Thin-lens: jitter the origin on the aperture disc and aim the ray
        # through the original focus point (kernel.glsl:1890-1903).
        use = dof_focus_distance > 0.0
        focus_pt = origin + direction * dof_focus_distance
        r = jnp.sqrt(dof_jitter[..., 0]) * dof_aperture_width
        theta = dof_jitter[..., 1] * 2.0 * jnp.pi
        shift = (
            cam["right"] * (jnp.cos(theta) * r)[..., None]
            + cam["up"] * (jnp.sin(theta) * r)[..., None]
        )
        new_origin = origin + shift
        new_dir = normalize(focus_pt - new_origin)
        origin = jnp.where(use, new_origin, origin)
        direction = jnp.where(use, new_dir, direction)

    return origin, direction


def generate_primary_rays_soa(
    cam: dict,
    width: int,
    height: int,
    pixel_ids,
    jit_u,
    jit_v,
    dof_focus_distance=0.0,
    dof_aperture_width=0.0,
    dof_u=None,
    dof_v=None,
    filter_width: float = 1.0,
):
    """SoA primary rays: (N,)-component V3 origins/directions.

    Same camera model as generate_primary_rays, with every vector kept as
    dense (N,) components (see core/vec3.py).
    """
    from tracerboy_tpu.core import vec3 as v3

    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    u = (px + 0.5 + (jit_u - 0.5) * filter_width) / width
    v = (py + 0.5 + (jit_v - 0.5) * filter_width) / height
    v = 1.0 - v

    aspect = width / height
    pos = v3.V3(cam["position"][0], cam["position"][1], cam["position"][2])
    look = v3.V3(cam["look_at"][0], cam["look_at"][1], cam["look_at"][2])
    right = v3.V3(cam["right"][0], cam["right"][1], cam["right"][2])
    up = v3.V3(cam["up"][0], cam["up"][1], cam["up"][2])
    forward = v3.normalize(look - pos)
    lens_w = cam["lens_height"] * aspect
    su = (u * 2.0 - 1.0) * lens_w / 2.0
    sv = (v * 2.0 - 1.0) * cam["lens_height"] / 2.0
    lens_point = v3.V3(
        pos.x + right.x * su + up.x * sv,
        pos.y + right.y * su + up.y * sv,
        pos.z + right.z * su + up.z * sv,
    )
    fx = pos.x - cam["focal_distance"] * forward.x
    fy = pos.y - cam["focal_distance"] * forward.y
    fz = pos.z - cam["focal_distance"] * forward.z
    origin = v3.V3(
        jnp.broadcast_to(fx, u.shape), jnp.broadcast_to(fy, u.shape),
        jnp.broadcast_to(fz, u.shape),
    )
    direction = v3.normalize(lens_point - origin)

    if dof_u is not None:
        use = dof_focus_distance > 0.0
        focus = origin + direction * dof_focus_distance
        r = jnp.sqrt(dof_u) * dof_aperture_width
        theta = dof_v * 2.0 * jnp.pi
        cr = jnp.cos(theta) * r
        sr = jnp.sin(theta) * r
        new_o = v3.V3(
            origin.x + right.x * cr + up.x * sr,
            origin.y + right.y * cr + up.y * sr,
            origin.z + right.z * cr + up.z * sr,
        )
        new_d = v3.normalize(focus - new_o)
        origin = v3.where(use, new_o, origin)
        direction = v3.where(use, new_d, direction)
    return origin, direction
