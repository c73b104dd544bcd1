"""Differentiable hit resolution + Phong shading terms.

The fixed-hit-topology reparameterization (BASELINE.json north-star):
traversal/selection produce only integer (kind, index) pairs; this module
*re-solves* the selected primitive's intersection in closed form, so
point/normal/UV/color are ordinary differentiable JAX expressions of the
scene parameters. Gradients flow to vertex positions, normals, materials,
lights and texels with no custom VJP.

Shading math parity (reference):
  * diffuse  = max(0, n . l)                      mytracer.cpp:510-515
  * specular = max(0, mirror(l, n) . view)^shin   mytracer.cpp:524-534
    gated on diffuse > 0
  * Phong-interpolated mesh normals are intentionally NOT normalized,
    matching mymesh.cpp:231-234 / mytracer_gpu.cu:505 exactly (the
    reference never renormalizes them; flat face normals are unit).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from myraytracer_tpu.ops import intersect as isx
from myraytracer_tpu.ops import texture as tex
from myraytracer_tpu.utils import vecmath as vm

# hit kinds
KIND_MISS = 0
KIND_SPHERE = 1
KIND_PLANE = 2
KIND_TRI = 3
KIND_CYL = 4

#: self-intersection offset for secondary rays (mytracer.cpp:550,570)
EPS_OFFSET = 1e-4


class Hit(NamedTuple):
    """Differentiable per-ray surface interaction."""

    valid: jnp.ndarray      # [R] bool
    t: jnp.ndarray          # [R]
    point: jnp.ndarray      # [R, 3]
    normal: jnp.ndarray     # [R, 3] (unnormalized for PHONG meshes — parity)
    diffuse: jnp.ndarray    # [R, 3] effective diffuse (texture-aware)
    ambient: jnp.ndarray    # [R, 3]
    specular: jnp.ndarray   # [R, 3]
    mirror: jnp.ndarray     # [R]
    shininess: jnp.ndarray  # [R]
    shadowable: jnp.ndarray # [R] float 0/1


class ShadeGeom(NamedTuple):
    """Pre-packed differentiable per-triangle / per-material rows.

    resolve_hit runs once per ray per Whitted segment; packing the
    triangle corner positions, corner normals, and the whole material
    table into lane-aligned rows turns its ~11 narrow per-ray gathers
    (3 vertex positions + 3 vertex normals + 5 material columns) into at
    most 3 wide row gathers. The win is partly in the BACKWARD (each
    gather's VJP is a full-image scatter-add pass) and partly device
    time: one wide row per key instead of several narrow ones (the
    per-gather cost on the H100 is not yet measured, ROADMAP 1.5).

    ``tri_pack`` therefore fuses the old tri16 + nrm16 tables into one
    [T, 32] row keyed by triangle id — and for a triangle-ONLY scene
    (the benchmark office included) the per-triangle MATERIAL row is
    joined too ([T, 48]): the per-ray material gather and the [T, 4]
    int-row gather disappear from the untextured tri-only hot path
    entirely (2 gathers instead of 4).

    The pack is an ordinary differentiable function of the scene params
    (NO stop_gradient): building it once per render pass and threading
    it through the per-tile scan means gradients accumulate into the
    packed cotangents tile by tile and hit the vertex/material arrays in
    ONE final unpack VJP. Joining mat rows per-tri keeps this exact —
    the join is itself a differentiable [T]-gather of mat16, so its VJP
    scatter-adds the per-tri cotangents back into the material arrays.

    Layout of ``tri_pack`` (f32):
      [:, 0:16]   p0 p1 p2 (9) | u0 u1 u2 v0 v1 v2 (6) | pad
      [:, 16:32]  n0 n1 n2 (9) | phong flag (1) | pad
      [:, 32:48]  (tri-only scenes) the triangle's mat16 row
    """

    tri_pack: jnp.ndarray  # [T, 32] or [T, 48] — see layout above
    tri_int: jnp.ndarray   # [T, 4] int32: mat id, tex W, tex H, tex offset
    mat16: jnp.ndarray     # [NM, 16] diffuse3 ambient3 specular3 shin mirror shadowable | pad


def _tri_only(scene) -> bool:
    """Triangles are the only primitive kind (office benchmark path)."""
    return bool(scene.n_tris) and not (
        scene.n_spheres or scene.n_planes or scene.n_cylinders)


def pack_shade_geom(scene) -> ShadeGeom:
    """Build the packed rows from the CURRENT (differentiable) params."""
    z1 = jnp.zeros((max(scene.n_tris, 1), 1), jnp.float32)
    nm = scene.mat_diffuse.shape[0]
    mat16 = jnp.concatenate([
        scene.mat_diffuse, scene.mat_ambient, scene.mat_specular,
        scene.mat_shininess[:, None], scene.mat_mirror[:, None],
        scene.mat_shadowable[:, None], jnp.zeros((nm, 4), jnp.float32),
    ], axis=1)
    if scene.n_tris:
        tv = scene.tri_vidx
        vp = scene.vertex_pos
        pos9 = jnp.concatenate([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]],
                               axis=1)
        if scene.has_textures:
            uv = scene.tri_uvidx
            uv6 = jnp.stack([
                scene.uv_u[uv[:, 0]], scene.uv_u[uv[:, 1]],
                scene.uv_u[uv[:, 2]], scene.uv_v[uv[:, 0]],
                scene.uv_v[uv[:, 1]], scene.uv_v[uv[:, 2]],
            ], axis=1)
        else:
            uv6 = jnp.zeros((scene.tri_vidx.shape[0], 6), jnp.float32)
        vn = scene.vertex_normal
        nrm9 = jnp.concatenate([vn[tv[:, 0]], vn[tv[:, 1]], vn[tv[:, 2]]],
                               axis=1)
        flag = (scene.tri_flags == 1).astype(jnp.float32)[:, None]
        parts = [pos9, uv6, 0.0 * z1,                       # [:, 0:16]
                 nrm9, flag, jnp.zeros((nrm9.shape[0], 6), jnp.float32)]
        if _tri_only(scene):
            parts.append(mat16[scene.tri_mat])              # [:, 32:48]
        tri_pack = jnp.concatenate(parts, axis=1)
        tri_int = jnp.concatenate(
            [scene.tri_mat[:, None], scene.tri_tex], axis=1)
    else:
        tri_pack = jnp.zeros((1, 32), jnp.float32)
        tri_int = jnp.zeros((1, 4), jnp.int32)
    return ShadeGeom(tri_pack=tri_pack, tri_int=tri_int, mat16=mat16)


def resolve_hit(scene, o, d, kind, idx, texture_filter: str = "nearest",
                need_colors: bool = True,
                geom: ShadeGeom | None = None) -> Hit:
    """Recompute the surface interaction for selected (kind, idx).

    All three primitive branches are evaluated for every ray and blended
    with ``where`` — compute-all-select is the vector-machine idiom; the
    per-branch work is tiny next to traversal.

    ``need_colors=False`` skips the diffuse/texture work entirely —
    diffuse comes back as zeros for every ray (the texture fetch is also
    gated off) — for callers that only need geometry + mirror/shadowable,
    i.e. the topology-recording pass (tracer.trace_topology).

    ``geom`` is the packed-row cache (:class:`ShadeGeom`); pass it in
    when resolving many batches against the same scene (the tracer does)
    so the packing gathers — and in the backward, their scatter VJPs —
    run once per render pass instead of once per tile/segment.
    """
    R = o.shape[0]
    if geom is None:
        geom = pack_shade_geom(scene)
    safe = jnp.maximum(idx, 0)

    t = jnp.zeros((R,), o.dtype)
    normal = jnp.zeros((R, 3), o.dtype)
    diffuse_override = jnp.zeros((R, 3), o.dtype)
    has_override = jnp.zeros((R,), bool)
    mat_id = jnp.zeros((R,), jnp.int32)

    if scene.n_spheres:
        si = jnp.clip(safe, 0, scene.n_spheres - 1)
        c = scene.sphere_center[si]
        r = scene.sphere_radius[si]
        t_s = ray_t_sphere(o, d, c, r)
        p_s = o + t_s[:, None] * d
        n_s = vm.normalize(p_s - c)
        is_s = kind == KIND_SPHERE
        t = jnp.where(is_s, t_s, t)
        normal = jnp.where(is_s[:, None], n_s, normal)
        mat_id = jnp.where(is_s, scene.sphere_mat[si], mat_id)

    if scene.n_planes:
        pi = jnp.clip(safe, 0, scene.n_planes - 1)
        n_p = scene.plane_normal[pi]
        c_p = scene.plane_center[pi]
        denom = vm.dot(n_p, d)
        denom = jnp.where(jnp.abs(denom) > isx.EPS_PARALLEL, denom, 1.0)
        t_p = (vm.dot(n_p, c_p) - vm.dot(n_p, o)) / denom
        is_p = kind == KIND_PLANE
        t = jnp.where(is_p, t_p, t)
        normal = jnp.where(is_p[:, None], n_p, normal)
        mat_id = jnp.where(is_p, scene.plane_mat[pi], mat_id)

    if scene.n_cylinders:
        ci = jnp.clip(safe, 0, scene.n_cylinders - 1)
        cc = scene.cyl_center[ci]
        ca = scene.cyl_axis[ci]
        cr = scene.cyl_radius[ci]
        ch = scene.cyl_height[ci]
        t_c = isx.ray_cylinder(o, d, cc, ca, cr, ch)
        t_c = jnp.where(t_c < isx.INF, t_c, 0.0)  # safe value for non-hits
        p_c = o + t_c[:, None] * d
        rel = p_c - cc
        n_c = vm.normalize(rel - vm.dot(rel, ca)[:, None] * ca)
        # flip outward normal toward the viewer for rays inside the tube
        n_c = jnp.where(vm.dot(n_c, d)[:, None] > 0, -n_c, n_c)
        is_c = kind == KIND_CYL
        t = jnp.where(is_c, t_c, t)
        normal = jnp.where(is_c[:, None], n_c, normal)
        mat_id = jnp.where(is_c, scene.cyl_mat[ci], mat_id)

    tri_only = scene.n_tris and geom.tri_pack.shape[1] == 48
    tri_mat_row = None
    if scene.n_tris:
        ti = jnp.clip(safe, 0, scene.n_tris - 1)
        rows48 = geom.tri_pack[ti]                  # [R, 32 or 48] ONE gather
        rows = rows48[:, 0:16]
        p0, p1, p2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        t_t, alpha, beta = isx.ray_triangle(o, d, p0, p1, p2)
        gamma = 1.0 - alpha - beta
        # flat face normal recomputed from vertices (differentiable),
        # equal to the reference's precomputed triangle.normal
        # (mymesh.cpp:116); PHONG interpolates UNnormalized (parity).
        n_flat = vm.normalize(vm.cross(p1 - p0, p2 - p0))
        nr = rows48[:, 16:32]
        n0, n1, n2 = nr[:, 0:3], nr[:, 3:6], nr[:, 6:9]
        n_phong = alpha[:, None] * n0 + beta[:, None] * n1 + gamma[:, None] * n2
        is_phong = nr[:, 9] > 0.5
        n_t = jnp.where(is_phong[:, None], n_phong, n_flat)

        # the [R, 4] int-row gather is needed only for texture records or
        # to blend mat ids across primitive kinds; the untextured
        # tri-only hot path (benchmark office) skips it entirely
        need_tex = need_colors and scene.has_textures
        if need_tex or not tri_only:
            ints = geom.tri_int[ti]                 # [R, 4]
        if tri_only:
            tri_mat_row = rows48[:, 32:48]
        is_t = kind == KIND_TRI
        t = jnp.where(is_t, t_t, t)
        normal = jnp.where(is_t[:, None], n_t, normal)
        if not tri_only:
            mat_id = jnp.where(is_t, ints[:, 0], mat_id)

        if need_tex:
            # texture
            u = (alpha * rows[:, 9] + beta * rows[:, 10]
                 + gamma * rows[:, 11])
            v = (alpha * rows[:, 12] + beta * rows[:, 13]
                 + gamma * rows[:, 14])
            rec = ints[:, 1:4]
            sampler = (tex.sample_bilinear if texture_filter == "bilinear"
                       else tex.sample_nearest)
            texel = sampler(scene.texels, rec, u, v)
            textured = is_t & (rec[:, 0] > 0)
            diffuse_override = jnp.where(
                textured[:, None], texel, diffuse_override)
            has_override = has_override | textured

    valid = kind != KIND_MISS
    point = o + t[:, None] * d
    # fp32 surface re-projection: near-tangent hits solve t with a large
    # relative error (the sqrt of a near-zero discriminant / a
    # near-singular Cramer system), leaving `point` measurably inside the
    # surface — shadow rays then exit through their OWN primitive at
    # t > EPS_HIT and silhouette pixels self-shadow (observed: molecule
    # silhouettes darkened vs the fp64 oracle by up to 0.3). Snapping the
    # point back onto the exact surface is the identity in real
    # arithmetic, differentiable, and kills the acne without any epsilon
    # tuning. (The fp64 reference never needs this; this is the fp32
    # counterpart of its 1e-4 shadow offset.)
    if scene.n_spheres:
        point = jnp.where(
            is_s[:, None],
            c + r[:, None] * vm.normalize(point - c), point)
    if scene.n_planes:
        point = jnp.where(
            is_p[:, None],
            point - vm.dot(n_p, point - c_p)[:, None] * n_p, point)
    if scene.n_cylinders:
        foot = cc + vm.dot(point - cc, ca)[:, None] * ca
        point = jnp.where(
            is_c[:, None],
            foot + cr[:, None] * vm.normalize(point - foot), point)
    if scene.n_tris:
        point = jnp.where(
            is_t[:, None],
            point - vm.dot(n_flat, point - p2)[:, None] * n_flat, point)
    # tri-only scenes read the material row straight out of the joined
    # tri_pack gather (rows for missed rays are row-0 values; every
    # consumer gates on valid/active, see trace.segment)
    mat = tri_mat_row if tri_only else geom.mat16[mat_id]  # [R, 16]
    if need_colors:
        diffuse = jnp.where(has_override[:, None], diffuse_override,
                            mat[:, 0:3])
        ambient = mat[:, 3:6]
        specular = mat[:, 6:9]
        shininess = mat[:, 9]
    else:
        diffuse = diffuse_override
        ambient = specular = jnp.zeros((R, 3), o.dtype)
        shininess = jnp.zeros((R,), o.dtype)
    return Hit(
        valid=valid,
        t=t,
        point=point,
        normal=normal,
        diffuse=diffuse,
        ambient=ambient,
        specular=specular,
        mirror=jnp.where(valid, mat[:, 10], 0.0),
        shininess=shininess,
        shadowable=mat[:, 11],
    )


def ray_t_sphere(o, d, center, radius):
    """Differentiable sphere-hit distance for a *known* hit (no miss mask).

    Double-where guards the sqrt: rays that did NOT select this sphere
    still evaluate this branch (compute-all-select), and sqrt'(0) = inf
    would turn their zero cotangents into NaNs that contaminate every
    upstream parameter through the bounce-origin chain.
    """
    oc = o - center
    b = 2.0 * vm.dot(oc, d)
    a = vm.dot(d, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    pos = disc > 1e-12
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    sq = jnp.where(pos, sq, 0.0)
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return jnp.where(t0 > isx.EPS_HIT, t0, t1)


def diffuse_term(normal, point, light_pos):
    """max(0, n . normalize(light - point)) (mytracer.cpp:510-515)."""
    l_dir = vm.normalize(light_pos - point)
    return jnp.maximum(0.0, vm.dot(normal, l_dir))


def specular_term(normal, point, view, light_pos, shininess):
    """Phong specular, gated on diffuse > 0 (mytracer.cpp:524-534).

    ``pow`` is guarded so the gradient at base == 0 stays finite.
    """
    l_dir = vm.normalize(light_pos - point)
    cos_d = vm.dot(normal, l_dir)
    r = vm.normalize(vm.mirror(l_dir, normal))
    cos_rv = jnp.maximum(0.0, vm.dot(r, view))
    gate = (cos_d > 0.0) & (cos_rv > 0.0)
    base = jnp.where(gate, cos_rv, 1.0)
    return jnp.where(gate, jnp.power(base, shininess), 0.0)
