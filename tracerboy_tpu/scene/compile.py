"""Scene compiler: SceneIR -> CompiledScene (device-ready pytree of arrays).

The analog of the reference's TracerBoy::LoadScene body
(TracerBoy/TracerBoy.cpp:1065-2161): material conversion, texture upload,
geometry upload (with curve tessellation, TracerBoy.cpp:1425-1524), light
extraction (TracerBoy.cpp:1527-1576, 1895-1934), acceleration structure
build, and blue-noise load — except everything lands in flat, world-space,
BVH-ordered SoA arrays instead of D3D buffers, and instancing is
flattened at compile time (the wavefront traversal then needs no
TLAS/BLAS distinction).

A compiled scene can be cached to .npz and reloaded ~instantly — the
counterpart of the reference's binary .pbf scene cache
(TracerBoy.cpp:1200-1223).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from tracerboy_tpu.accel.native import build_bvh_auto as build_bvh
from tracerboy_tpu.scene import types as ir
from tracerboy_tpu.scene.curves import tessellate_curve
from tracerboy_tpu.scene.materials import (
    MaterialTable,
    convert_material,
    LIGHT_FLAG,
)
from tracerboy_tpu.scene.textures import TextureAllocator
from tracerboy_tpu.trace.camera import Camera

LEAF_SIZE = 4


@dataclass
class CompiledScene:
    """Host-side compiled scene; `as_pytree()` moves it to device arrays.

    All triangle-indexed arrays are in BVH (morton) order and padded to a
    multiple of the BVH leaf size with degenerate copies of the last tri.
    """

    # geometry (T_padded, ...)
    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_uv0: np.ndarray
    tri_uv1: np.ndarray
    tri_uv2: np.ndarray
    tri_material: np.ndarray     # (T_padded,) int32
    num_tris: int
    # BVH
    bvh_lo: np.ndarray
    bvh_hi: np.ndarray
    bvh_children: np.ndarray
    leaf_size: int
    # materials / textures
    materials: dict
    tex_images: np.ndarray
    tex_sizes: np.ndarray
    tex_records: dict
    # lights
    lights: dict                 # SoA: p0..p2, n0..n2, color, area, ltype, direction
    num_lights: int
    # environment
    env_map: np.ndarray          # (H, W, 3) float32 (black 1x1 if none)
    env_transform: np.ndarray    # (3, 3)
    env_color_scale: np.ndarray  # (3,)
    has_env: bool
    # camera & film
    camera: Camera
    film_width: int
    film_height: int
    sampler_spp: int
    max_depth: int
    # blue noise
    blue_noise0: np.ndarray      # (256, 256, 4) in [0,1)
    blue_noise1: np.ndarray
    # heterogeneous volume (reference TracerBoy.cpp:1096-1184: one
    # density grid + world bounds; the shading that the reference never
    # wired up lives in trace/wavefront.py as a delta-tracking medium)
    vol_density: np.ndarray = None   # (D, H, W) float32; None = no volume
    vol_lo: np.ndarray = None        # (3,)
    vol_hi: np.ndarray = None
    vol_sigma_a: np.ndarray = None   # (3,)
    vol_sigma_s: np.ndarray = None   # (3,)
    vol_g: float = 0.0
    @property
    def has_volume(self) -> bool:
        return self.vol_density is not None

    def as_pytree(self) -> dict:
        """Device-ready dict pytree (jnp arrays) for the render step."""
        import jax.numpy as jnp

        def j(x):
            return jnp.asarray(x)

        # SoA-layout companions (see core/vec3.py): fused triangle data,
        # flattened texture channels.
        tri9 = np.concatenate(
            [self.tri_v0, self.tri_v1, self.tri_v2], axis=1
        ).astype(np.float32)
        # Per-triangle tangent from the UV parameterization (flat frame;
        # the reference interpolates per-vertex tangents computed at load,
        # TracerBoy.cpp:1603-1684) — consumed by GetDetailNormal-style
        # normal mapping (RayGenCommon.h:273-295).
        e1 = self.tri_v1 - self.tri_v0
        e2 = self.tri_v2 - self.tri_v0
        d1 = self.tri_uv1 - self.tri_uv0
        d2 = self.tri_uv2 - self.tri_uv0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        bad = np.abs(det) < 1e-12
        tan = e1 * d2[:, 1:2] - e2 * d1[:, 1:2]
        tan = np.where(
            bad[:, None], e1, tan / np.where(bad, 1.0, det)[:, None]
        )
        tan = tan / np.maximum(
            np.linalg.norm(tan, axis=1, keepdims=True), 1e-12
        )

        tri_attr_t = np.concatenate(
            [
                self.tri_n0.T, self.tri_n1.T, self.tri_n2.T,   # 0:9
                self.tri_uv0.T, self.tri_uv1.T, self.tri_uv2.T,  # 9:15
                self.tri_material[None, :].astype(np.float32),   # 15
                tan.T,                                           # 16:19
            ],
            axis=0,
        ).astype(np.float32)
        tri_attr_rows = np.ascontiguousarray(tri_attr_t.T)   # (T, 19)

        env_flat = self.env_map.reshape(-1, 3).astype(np.float32)

        # Bilinear quad rows: row i = the 2x2 texel neighborhood of texel
        # i (x+1 wrapped, y+1 clamped), 12 floats. One row-gather fetches
        # all four taps.
        eh, ew = self.env_map.shape[0], self.env_map.shape[1]
        ex = np.arange(ew)
        ey = np.arange(eh)
        x1 = (ex + 1) % ew
        y1 = np.minimum(ey + 1, eh - 1)
        em = self.env_map.astype(np.float32)
        env_quad = np.concatenate(
            [
                em,                       # (y, x)
                em[:, x1],                # (y, x+1)
                em[y1],                   # (y+1, x)
                em[y1][:, x1],            # (y+1, x+1)
            ],
            axis=2,
        ).reshape(-1, 12)

        volume = {}
        if self.has_volume:
            dd = self.vol_density
            sig_t = self.vol_sigma_a + self.vol_sigma_s
            # Trilinear stencil rows (the env_quad trick in 3D): row c
            # (voxel z,y,x) holds the 8 corner densities of the trilerp
            # cell anchored at c, so ONE row-gather fetches the whole
            # stencil. 8x grid memory.
            D_, H_, W_ = dd.shape
            zs = np.minimum(np.arange(D_) + 1, D_ - 1)
            ys = np.minimum(np.arange(H_) + 1, H_ - 1)
            xs = np.minimum(np.arange(W_) + 1, W_ - 1)
            oct_rows = np.stack(
                [
                    dd, dd[:, :, xs], dd[:, ys], dd[:, ys][:, :, xs],
                    dd[zs], dd[zs][:, :, xs], dd[zs][:, ys],
                    dd[zs][:, ys][:, :, xs],
                ],
                axis=-1,
            ).reshape(-1, 8).astype(np.float32)
            # Per-triangle area for the phase<->light MIS weight at
            # emissive hits (per-tri light records make the solid-angle
            # light pdf exact: p = d^2 / (num_lights * area * cos)).
            # Volume scenes only — keeps non-volume pytrees (and their
            # compile-cache keys) unchanged.
            te1 = self.tri_v1 - self.tri_v0
            te2 = self.tri_v2 - self.tri_v0
            tri_area = np.maximum(
                0.5 * np.linalg.norm(np.cross(te1, te2), axis=1), 1e-12
            ).astype(np.float32)
            volume = dict(
                tri_area=j(tri_area),
                vol_density=j(dd.reshape(-1)),
                vol_oct=j(oct_rows),
                vol_dims=j(np.array(dd.shape, np.int32)),
                vol_lo=j(self.vol_lo), vol_hi=j(self.vol_hi),
                vol_sigma_a=j(self.vol_sigma_a),
                vol_sigma_s=j(self.vol_sigma_s),
                vol_g=j(np.float32(self.vol_g)),
                # Delta-tracking majorant: max density x largest channel
                # extinction, padded 10% above the true bound so the
                # null-collision branch keeps nonzero probability
                # everywhere — required for unbiased SPECTRAL weights
                # when density*sigma_t_max touches the majorant (Kutz et
                # al. 2017 bounded majorant).
                vol_majorant=j(np.float32(
                    max(float(dd.max()) * float(sig_t.max()), 1e-8)
                    * 1.1)),
            )

        return dict(
            **volume,
            tri9=j(tri9),
            tri_attr_rows=j(tri_attr_rows),
            env_quad=j(env_quad),
            env_r=j(env_flat[:, 0]), env_g=j(env_flat[:, 1]),
            env_b=j(env_flat[:, 2]),
            blue0_t=j(self.blue_noise0.reshape(-1, 4).T.copy()),
            blue1_t=j(self.blue_noise1.reshape(-1, 4).T.copy()),
            tri_v0=j(self.tri_v0), tri_v1=j(self.tri_v1), tri_v2=j(self.tri_v2),
            tri_n0=j(self.tri_n0), tri_n1=j(self.tri_n1), tri_n2=j(self.tri_n2),
            tri_uv0=j(self.tri_uv0), tri_uv1=j(self.tri_uv1),
            tri_uv2=j(self.tri_uv2),
            tri_material=j(self.tri_material),
            # Shadow rays ignore emissive (light) geometry, matching the
            # reference's IsLight pass-through in shadow feelers.
            tri_shadow_opaque=j(
                (self.materials["flags"][self.tri_material] & 0x10) == 0
            ),
            bvh_lo=j(self.bvh_lo), bvh_hi=j(self.bvh_hi),
            bvh_children=j(self.bvh_children),
            materials={k: j(v) for k, v in self.materials.items()},
            tex_images=j(self.tex_images), tex_sizes=j(self.tex_sizes),
            tex_records={k: j(v) for k, v in self.tex_records.items()},
            lights={k: j(v) for k, v in self.lights.items()},
            env_map=j(self.env_map), env_transform=j(self.env_transform),
            env_color_scale=j(self.env_color_scale),
            blue_noise0=j(self.blue_noise0), blue_noise1=j(self.blue_noise1),
            camera=self.camera.as_pytree(),
        )


def _transform_mesh(mesh: ir.TriangleMeshIR):
    """Bake the mesh transform: world-space verts + inverse-transpose normals."""
    M = mesh.transform
    pos = mesh.positions @ M[:3, :3].T + M[:3, 3]
    if mesh.normals is not None and len(mesh.normals) == len(mesh.positions):
        it = np.linalg.inv(M[:3, :3]).T
        nrm = mesh.normals @ it.T
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-12)
    else:
        nrm = None
    return pos.astype(np.float32), nrm


def _sphere_mesh(radius: float, lat: int = 16, lon: int = 32):
    """UV-sphere tessellation for pbrt `sphere` shapes."""
    th = np.linspace(0, np.pi, lat + 1)
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], axis=-1
    ).reshape(-1, 3)
    idx = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            if i > 0:
                idx.append((a, b, c))
            if i < lat - 1:
                idx.append((b, d, c))
    pts = pts.astype(np.float32)
    return pts * radius, np.asarray(idx, np.int32), pts.copy()


def _shape_to_tris(shape, scene, table, tex_alloc, material_lookup):
    """One shape -> (tri_pos (t,3,3), tri_nrm, tri_uv, mat_id, emission)
    in the shape's transform frame. Returns None for unsupported
    shapes."""
    emission = getattr(shape, "emission", None)
    mat_ir = scene.materials.get(shape.material)
    alpha_tex = getattr(shape, "alpha_texture", None)
    mat_id = convert_material(
        mat_ir, emission if emission is not None else (0, 0, 0),
        table, tex_alloc, material_lookup, alpha_texture=alpha_tex,
    )
    if isinstance(shape, ir.TriangleMeshIR):
        pos, nrm = _transform_mesh(shape)
        idx, uv = shape.indices, shape.uvs
    elif isinstance(shape, ir.SphereIR):
        pos, idx, nrm0 = _sphere_mesh(shape.radius)
        M = shape.transform
        pos = (pos @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
        it = np.linalg.inv(M[:3, :3]).T
        nrm = nrm0 @ it.T
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
        nrm = nrm.astype(np.float32)
        uv = None
    elif isinstance(shape, ir.CurveIR):
        pos, idx, nrm0 = tessellate_curve(
            shape.control_points, shape.width0, shape.width1
        )
        M = shape.transform
        pos = (pos @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
        it = np.linalg.inv(M[:3, :3]).T
        nrm = nrm0 @ it.T
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
        nrm = nrm.astype(np.float32)
        uv = None
    else:
        return None
    tri_pos = pos[idx]
    if nrm is not None and len(nrm) == len(pos):
        tri_nrm = nrm[idx]
    else:
        e1 = tri_pos[:, 1] - tri_pos[:, 0]
        e2 = tri_pos[:, 2] - tri_pos[:, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        tri_nrm = np.repeat(fn[:, None, :], 3, axis=1)
    if shape.reverse_orientation:
        tri_nrm = -tri_nrm
    if uv is not None:
        tri_uv = uv[idx]
    else:
        tri_uv = np.zeros((len(idx), 3, 2), np.float32)
    return (tri_pos.astype(np.float32), tri_nrm.astype(np.float32),
            tri_uv.astype(np.float32), mat_id, emission)


def compile_scene(
    scene: ir.SceneIR,
    leaf_size: int = LEAF_SIZE,
    film_size: tuple | None = None,
) -> CompiledScene:
    """Flatten, tessellate and BVH-order a parsed scene. Object
    instances are composed into the flat triangle soup (one BVH over
    world-space triangles; no TLAS/BLAS split)."""
    table = MaterialTable()
    tex_alloc = TextureAllocator(scene.base_dir, scene.textures)

    def material_lookup(name):
        return scene.materials.get(name)

    # --- gather world-space triangle soup -------------------------------
    v_chunks, n_chunks, uv_chunks, mat_chunks = [], [], [], []
    light_records = []

    def add_light_records(tri_pos, tri_nrm, emission):
        for k in range(len(tri_pos)):
            p0, p1, p2 = tri_pos[k]
            area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))
            light_records.append(
                dict(
                    p0=p0, p1=p1, p2=p2,
                    n0=tri_nrm[k, 0], n1=tri_nrm[k, 1], n2=tri_nrm[k, 2],
                    color=np.asarray(emission, np.float32),
                    area=float(area), ltype=0,
                    direction=np.zeros(3, np.float32),
                )
            )

    for shape in scene.all_shapes():
        r = _shape_to_tris(shape, scene, table, tex_alloc, material_lookup)
        if r is None:
            continue
        tri_pos, tri_nrm, tri_uv, mat_id, emission = r
        v_chunks.append(tri_pos)
        n_chunks.append(tri_nrm)
        uv_chunks.append(tri_uv)
        mat_chunks.append(np.full(len(tri_pos), mat_id, np.int32))
        if emission is not None and np.mean(emission) > 0:
            add_light_records(tri_pos, tri_nrm, emission)

    if not v_chunks:
        raise ValueError("scene contains no supported geometry")

    tri_pos = np.concatenate(v_chunks)     # (T, 3, 3)
    tri_nrm = np.concatenate(n_chunks)
    tri_uv = np.concatenate(uv_chunks)
    tri_mat = np.concatenate(mat_chunks)
    T = tri_pos.shape[0]

    # --- BVH + reorder ---------------------------------------------------
    bvh = build_bvh(
        tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2], leaf_size=leaf_size
    )
    order = bvh.tri_order  # (T_padded,)
    tri_pos = tri_pos[order]
    tri_nrm = tri_nrm[order]
    tri_uv = tri_uv[order]
    tri_mat = tri_mat[order]

    # --- non-area lights -------------------------------------------------
    env_map = np.zeros((1, 1, 3), np.float32)
    env_transform = np.eye(3, dtype=np.float32)
    env_color_scale = np.ones(3, np.float32)
    has_env = False
    for light in scene.lights:
        if isinstance(light, ir.InfiniteLightIR):
            if light.mapname:
                from tracerboy_tpu.core import image_io

                path = os.path.join(scene.base_dir, light.mapname)
                if os.path.exists(path):
                    env_map = image_io.read_texture(path).astype(np.float32)
                else:
                    import warnings

                    warnings.warn(f"env map not found: {path}")
                    env_map = np.ones((1, 1, 3), np.float32)
            else:
                env_map = np.ones((1, 1, 3), np.float32)
            scale = light.scale if light.scale is not None else np.ones(3)
            L = light.L if light.L is not None else np.ones(3)
            env_color_scale = (np.asarray(scale) * np.asarray(L)).astype(
                np.float32
            )
            # World->env rotation; the shader rotates the lookup direction
            # (RayGenCommon.h:21-27 uses the light-to-world inverse).
            env_transform = np.linalg.inv(
                light.transform[:3, :3]
            ).astype(np.float32)
            has_env = True
        elif isinstance(light, ir.DistantLightIR):
            d = light.transform[:3, :3] @ np.asarray(light.direction, np.float64)
            d = d / np.linalg.norm(d)
            light_records.append(
                dict(
                    p0=np.zeros(3, np.float32), p1=np.zeros(3, np.float32),
                    p2=np.zeros(3, np.float32),
                    n0=-d.astype(np.float32), n1=-d.astype(np.float32),
                    n2=-d.astype(np.float32),
                    color=np.asarray(light.L, np.float32),
                    area=1.0, ltype=1, direction=d.astype(np.float32),
                )
            )
        elif isinstance(light, ir.PointLightIR):
            # Tiny emissive quad stand-in (the AssimpImporter's trick,
            # AssimpImporter.cpp:141-171).
            c = light.transform[:3, :3] @ light.from_point + light.transform[:3, 3]
            eps = 0.02
            quad = np.array(
                [
                    c + [-eps, -eps, 0], c + [eps, -eps, 0],
                    c + [eps, eps, 0], c + [-eps, eps, 0],
                ],
                np.float32,
            )
            n = np.array([0, 0, -1], np.float32)
            intensity = np.asarray(light.I, np.float32) / (eps * eps * 2)
            for a, b, cc in ((0, 1, 2), (0, 2, 3)):
                area = 0.5 * np.linalg.norm(
                    np.cross(quad[b] - quad[a], quad[cc] - quad[a])
                )
                light_records.append(
                    dict(
                        p0=quad[a], p1=quad[b], p2=quad[cc],
                        n0=n, n1=n, n2=n, color=intensity,
                        area=float(area), ltype=0,
                        direction=np.zeros(3, np.float32),
                    )
                )

    L = max(len(light_records), 1)
    lights = dict(
        p0=np.zeros((L, 3), np.float32), p1=np.zeros((L, 3), np.float32),
        p2=np.zeros((L, 3), np.float32), n0=np.zeros((L, 3), np.float32),
        n1=np.zeros((L, 3), np.float32), n2=np.zeros((L, 3), np.float32),
        color=np.zeros((L, 3), np.float32), area=np.zeros(L, np.float32),
        ltype=np.zeros(L, np.int32), direction=np.zeros((L, 3), np.float32),
    )
    for i, r in enumerate(light_records):
        for k in ("p0", "p1", "p2", "n0", "n1", "n2", "color", "direction"):
            lights[k][i] = r[k]
        lights["area"][i] = r["area"]
        lights["ltype"][i] = r["ltype"]

    # --- textures, blue noise, camera -----------------------------------
    tex_images, tex_sizes, tex_records = tex_alloc.to_arrays()
    blue0, blue1 = _load_blue_noise()

    width = scene.film.xresolution
    height = scene.film.yresolution
    if film_size is not None:
        width, height = film_size
    camera = Camera.from_pbrt(scene.camera, width, height)

    return CompiledScene(
        tri_v0=tri_pos[:, 0], tri_v1=tri_pos[:, 1], tri_v2=tri_pos[:, 2],
        tri_n0=tri_nrm[:, 0], tri_n1=tri_nrm[:, 1], tri_n2=tri_nrm[:, 2],
        tri_uv0=tri_uv[:, 0], tri_uv1=tri_uv[:, 1], tri_uv2=tri_uv[:, 2],
        tri_material=tri_mat, num_tris=T,
        bvh_lo=bvh.bounds_lo, bvh_hi=bvh.bounds_hi,
        bvh_children=bvh.children, leaf_size=leaf_size,
        materials=table.to_soa(),
        tex_images=tex_images, tex_sizes=tex_sizes, tex_records=tex_records,
        lights=lights, num_lights=len(light_records),
        env_map=env_map, env_transform=env_transform,
        env_color_scale=env_color_scale, has_env=has_env,
        camera=camera, film_width=width, film_height=height,
        sampler_spp=scene.sampler.pixel_samples,
        max_depth=scene.integrator.max_depth,
        blue_noise0=blue0, blue_noise1=blue1,
        **(
            dict(
                vol_density=scene.volume.density,
                vol_lo=scene.volume.lo, vol_hi=scene.volume.hi,
                vol_sigma_a=scene.volume.sigma_a,
                vol_sigma_s=scene.volume.sigma_s,
                vol_g=scene.volume.g,
            )
            if getattr(scene, "volume", None) is not None
            else {}
        ),
    )


def _load_blue_noise():
    """The two 256x256 RGBA tables of the blue-noise primary-sample
    streams (SURVEY G5). The reference's blue-noise PNGs are not part
    of this repository, so the tables are seeded white noise."""
    rng = np.random.default_rng(0xB1E)
    return (
        rng.random((256, 256, 4)).astype(np.float32),
        rng.random((256, 256, 4)).astype(np.float32),
    )


# ----------------------------------------------------------------------------
# .npz scene cache (the .pbf analog, TracerBoy.cpp:1200-1223)

_SCALAR_FIELDS = (
    "num_tris", "leaf_size", "num_lights", "has_env", "film_width",
    "film_height", "sampler_spp", "max_depth",
)


def save_compiled(path: str, cs: CompiledScene) -> None:
    flat = {}
    for name in (
        "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
        "tri_uv0", "tri_uv1", "tri_uv2", "tri_material", "bvh_lo", "bvh_hi",
        "bvh_children", "tex_images", "tex_sizes", "env_map",
        "env_transform", "env_color_scale", "blue_noise0", "blue_noise1",
    ):
        flat[name] = getattr(cs, name)
    for d, prefix in ((cs.materials, "mat."), (cs.tex_records, "tex."),
                      (cs.lights, "light.")):
        for k, v in d.items():
            flat[prefix + k] = v
    for name in _SCALAR_FIELDS:
        flat["scalar." + name] = np.asarray(getattr(cs, name))
    if cs.has_volume:
        flat["vol.density"] = cs.vol_density
        flat["vol.lo"] = cs.vol_lo
        flat["vol.hi"] = cs.vol_hi
        flat["vol.sigma_a"] = cs.vol_sigma_a
        flat["vol.sigma_s"] = cs.vol_sigma_s
        flat["vol.g"] = np.asarray(cs.vol_g)
    cam = cs.camera
    flat["cam.position"] = cam.position
    flat["cam.look_at"] = cam.look_at
    flat["cam.up"] = cam.up
    flat["cam.right"] = cam.right
    flat["cam.scalars"] = np.array([cam.lens_height, cam.focal_distance])
    np.savez_compressed(path, **flat)


def load_compiled(path: str) -> CompiledScene:
    z = np.load(path)
    mats = {k[4:]: z[k] for k in z.files if k.startswith("mat.")}
    texr = {k[4:]: z[k] for k in z.files if k.startswith("tex.") and not k.startswith("tex_")}
    lights = {k[6:]: z[k] for k in z.files if k.startswith("light.")}
    scal = {n: z["scalar." + n][()] for n in _SCALAR_FIELDS}
    cam = Camera(
        position=z["cam.position"], look_at=z["cam.look_at"],
        up=z["cam.up"], right=z["cam.right"],
        lens_height=float(z["cam.scalars"][0]),
        focal_distance=float(z["cam.scalars"][1]),
    )
    return CompiledScene(
        tri_v0=z["tri_v0"], tri_v1=z["tri_v1"], tri_v2=z["tri_v2"],
        tri_n0=z["tri_n0"], tri_n1=z["tri_n1"], tri_n2=z["tri_n2"],
        tri_uv0=z["tri_uv0"], tri_uv1=z["tri_uv1"], tri_uv2=z["tri_uv2"],
        tri_material=z["tri_material"], num_tris=int(scal["num_tris"]),
        bvh_lo=z["bvh_lo"], bvh_hi=z["bvh_hi"],
        bvh_children=z["bvh_children"], leaf_size=int(scal["leaf_size"]),
        materials=mats, tex_images=z["tex_images"], tex_sizes=z["tex_sizes"],
        tex_records=texr, lights=lights, num_lights=int(scal["num_lights"]),
        env_map=z["env_map"], env_transform=z["env_transform"],
        env_color_scale=z["env_color_scale"], has_env=bool(scal["has_env"]),
        camera=cam, film_width=int(scal["film_width"]),
        film_height=int(scal["film_height"]),
        sampler_spp=int(scal["sampler_spp"]),
        max_depth=int(scal["max_depth"]),
        blue_noise0=z["blue_noise0"], blue_noise1=z["blue_noise1"],
        vol_density=z["vol.density"] if "vol.density" in z.files else None,
        vol_lo=z["vol.lo"] if "vol.lo" in z.files else None,
        vol_hi=z["vol.hi"] if "vol.hi" in z.files else None,
        vol_sigma_a=(z["vol.sigma_a"] if "vol.sigma_a" in z.files
                     else None),
        vol_sigma_s=(z["vol.sigma_s"] if "vol.sigma_s" in z.files
                     else None),
        vol_g=float(z["vol.g"]) if "vol.g" in z.files else 0.0,
    )


def load_scene_async(path: str, use_cache: bool = True, film_size=None,
                     on_progress=None):
    """Load a scene on a worker thread (the reference's async scene-load
    thread, D3D12App.cpp:53-68). Returns a Future; poll .done() for the
    loading screen, .result() for the CompiledScene."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def run():
        if on_progress:
            on_progress("parsing")
        cs = load_scene(path, use_cache=use_cache, film_size=film_size)
        if on_progress:
            on_progress("done")
        return cs

    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def _cache_path(path: str) -> str:
    """Where the compiled .npz for `path` lives.

    Adjacent `<scene>.tbcache.npz` when the scene directory is writable
    (so the cache travels with the scene, like the reference's .pbf
    serialization — PBRTParser serializes parsed scenes to a binary
    sidecar for the same reload-latency reason); otherwise a keyed file
    under $TB_SCENE_CACHE (default ~/.cache/tracerboy_tpu), which covers
    read-only scene checkouts."""
    adjacent = path + ".tbcache.npz"
    scene_dir = os.path.dirname(os.path.abspath(path))
    if os.access(scene_dir, os.W_OK):
        return adjacent
    import hashlib

    cache_dir = os.environ.get(
        "TB_SCENE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tracerboy_tpu"))
    key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"{os.path.basename(path)}.{key}.npz")


def load_scene(path: str, use_cache: bool = True, film_size=None) -> CompiledScene:
    """Parse + compile a scene file, with transparent .npz caching.

    The cache stores the scene at its NATIVE film resolution; a
    film_size override only replaces the film dims on the returned
    CompiledScene (the camera model is film-size independent — aspect
    is derived at ray generation, trace/camera.py:108), so one cached
    compile serves every render resolution.

    "shadertoy" / "shadertoy:<name>" selects a built-in procedural scene
    (scene/procedural.py — the reference kernel's IS_SHADER_TOY mode)."""
    import dataclasses

    if path == "shadertoy" or path.startswith("shadertoy:"):
        from tracerboy_tpu.scene.procedural import shadertoy_scene

        name = path.split(":", 1)[1] if ":" in path else "benchmark"
        return shadertoy_scene(name, film_size=film_size)
    if path.endswith(".npz"):
        cs = load_compiled(path)
        if film_size is not None:
            cs = dataclasses.replace(
                cs, film_width=film_size[0], film_height=film_size[1])
        return cs

    def with_film(cs):
        if film_size is not None:
            cs = dataclasses.replace(
                cs, film_width=film_size[0], film_height=film_size[1])
        return cs

    cache = _cache_path(path)
    if use_cache and os.path.exists(cache) and (
        os.path.getmtime(cache) >= os.path.getmtime(path)
    ):
        try:
            return with_film(load_compiled(cache))
        except Exception:
            pass
    ext = os.path.splitext(path)[1].lower()
    if ext in (".obj", ".stl", ".gltf", ".glb"):
        from tracerboy_tpu.scene.mesh_import import import_mesh_scene

        scene_ir = import_mesh_scene(path)
    elif ext == ".pbf":
        from tracerboy_tpu.scene.pbf import read_pbf

        scene_ir = read_pbf(path)
    else:
        from tracerboy_tpu.scene.pbrt_parser import parse_pbrt

        scene_ir = parse_pbrt(path)
    cs = compile_scene(scene_ir, film_size=None)
    if use_cache:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            # Write then rename: concurrent loaders never see a partial
            # file.
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            save_compiled(tmp, cs)
            os.replace(tmp, cache)
        except OSError:
            pass  # unwritable cache dir: skip caching
    return with_film(cs)
