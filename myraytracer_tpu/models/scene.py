"""Scene model: host-side authoring container + device-side SoA pytree.

``Scene`` plays the role of the reference's ``Raytracer`` scene state
(objects_/meshes_/lights_/camera_/background_/ambience_/max_depth_,
mytracer.cpp:27-36) plus its AoS->SoA packer ``build_Data``
(mytracer.cpp:166-296): meshes are flattened into global vertex/index
arrays with rebased indices, per-mesh texture blocks are concatenated into
one texel atlas, and materials live in one table indexed per object.

``SceneData`` is the device-side result: a single JAX pytree of flat
float32/int32 arrays (static shapes), replicated into each chip's HBM.
Every differentiable quantity (vertex positions, vertex normals, material
colors, light parameters, texels, sphere/plane geometry) is a pytree leaf,
so ``jax.grad`` flows into it with no extra machinery.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from myraytracer_tpu.models.camera import Camera
from myraytracer_tpu.models.light import Light
from myraytracer_tpu.models.material import Material
from myraytracer_tpu.models.mesh import TriangleMesh
from myraytracer_tpu.ops import bvh as bvh_mod


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat device SoA scene. All arrays jnp, all shapes static."""

    # --- analytic primitives ---
    sphere_center: jnp.ndarray   # [S, 3]
    sphere_radius: jnp.ndarray   # [S]
    sphere_mat: jnp.ndarray      # [S] int32 -> material table
    plane_center: jnp.ndarray    # [P, 3]
    plane_normal: jnp.ndarray    # [P, 3]
    plane_mat: jnp.ndarray       # [P] int32
    cyl_center: jnp.ndarray      # [C, 3]
    cyl_axis: jnp.ndarray        # [C, 3] unit
    cyl_radius: jnp.ndarray      # [C]
    cyl_height: jnp.ndarray      # [C]
    cyl_mat: jnp.ndarray         # [C] int32

    # --- triangle geometry (BVH-ordered) ---
    vertex_pos: jnp.ndarray      # [V, 3]
    vertex_normal: jnp.ndarray   # [V, 3]
    tri_vidx: jnp.ndarray        # [T, 3] int32
    tri_uvidx: jnp.ndarray       # [T, 3] int32 (0 when mesh has no UVs)
    tri_mat: jnp.ndarray         # [T] int32
    tri_flags: jnp.ndarray       # [T] int32: draw mode (0 FLAT / 1 PHONG)
    tri_tex: jnp.ndarray         # [T, 3] int32: (tex_w, tex_h, tex_offset); w=-1 -> untextured
    uv_u: jnp.ndarray            # [U]
    uv_v: jnp.ndarray            # [U]
    texels: jnp.ndarray          # [X, 3] texture atlas

    # --- material table ---
    mat_ambient: jnp.ndarray     # [Mt, 3]
    mat_diffuse: jnp.ndarray     # [Mt, 3]
    mat_specular: jnp.ndarray    # [Mt, 3]
    mat_mirror: jnp.ndarray      # [Mt]
    mat_shininess: jnp.ndarray   # [Mt]
    mat_shadowable: jnp.ndarray  # [Mt] float 0/1

    # --- lights & globals ---
    light_pos: jnp.ndarray       # [L, 3]
    light_color: jnp.ndarray     # [L, 3]
    background: jnp.ndarray      # [3]
    ambience: jnp.ndarray        # [3]

    # --- BVH (threaded, octant-ordered; ops/bvh.py) ---
    bvh_bbmin: jnp.ndarray       # [N, 3]
    bvh_bbmax: jnp.ndarray       # [N, 3]
    bvh_first: jnp.ndarray       # [N] int32
    bvh_count: jnp.ndarray       # [N] int32 (0 = internal)
    bvh_entry: jnp.ndarray       # [8, N] int32
    bvh_skip: jnp.ndarray        # [8, N] int32
    # packed traversal mirrors: ONE row-gather per traversal step instead
    # of six (gathers bound the traversal).
    bvh_nodes_packed: jnp.ndarray  # [N, 8] f32: bbmin, bbmax, bits(first), bits(count)
    bvh_links_packed: jnp.ndarray  # [8N, 2] i32: (entry, skip) per octant-major node
    # per-node triangle ranges [lo, hi): every node (leaf AND internal)
    # covers a contiguous run of the leaf-ordered triangle array. Stored
    # for ops/refit.refit_accel, which recomputes node/cluster AABBs from
    # the CURRENT vertex_pos when geometry is optimized (the reference
    # builds bounds once because its geometry is static, mybvh.cpp:44,375;
    # this framework's vertex_pos is a differentiable leaf).
    bvh_lo: jnp.ndarray          # [N] int32
    bvh_hi: jnp.ndarray          # [N] int32

    # --- cluster cut (ops/cluster.py, the dense streaming scan) ---
    cl_first: jnp.ndarray        # [K] int32 first triangle of cluster
    cl_count: jnp.ndarray        # [K] int32
    cl_bbmin: jnp.ndarray        # [K, 3]
    cl_bbmax: jnp.ndarray        # [K, 3]

    # --- static config ---
    max_depth: int = dataclasses.field(metadata=dict(static=True), default=3)
    max_leaf: int = dataclasses.field(metadata=dict(static=True), default=2)
    cl_M: int = dataclasses.field(metadata=dict(static=True), default=128)
    #: static Whitted segment count actually traced. 0 = unset (use
    #: max_depth + 1). Scene.build() sets 1 when NO material has
    #: mirror > 0: every ray dies after the primary segment, so the
    #: mirror-chain iterations are provably dead — this trims the trace /
    #: topology / shading-replay scans (the static analogue of the CPU
    #: reference's mirror>0 early-exit, mytracer.cpp:547). Caveat: with
    #: live_depth=1 the analytic d(image)/d(mat_mirror) at mirror==0
    #: drops the reflected-radiance term (one-sided derivative).
    live_depth: int = dataclasses.field(metadata=dict(static=True), default=0)
    #: False when NO triangle carries a texture record — shade.resolve_hit
    #: statically skips the uv gathers + atlas sample (gather-heavy, pure
    #: dead work for untextured scenes). Defaults to True (safe: sample).
    has_textures: bool = dataclasses.field(metadata=dict(static=True),
                                           default=True)

    # static shape helpers (shapes are trace-time constants under jit)
    @property
    def n_segments(self) -> int:
        """Static number of Whitted segments to trace (see live_depth)."""
        return self.live_depth if self.live_depth > 0 else self.max_depth + 1

    @property
    def n_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def n_planes(self) -> int:
        return self.plane_center.shape[0]

    @property
    def n_cylinders(self) -> int:
        return self.cyl_center.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_vidx.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.bvh_bbmin.shape[0]


class Scene:
    """Host-side scene under construction. Call :meth:`build` to pack."""

    def __init__(self) -> None:
        self.camera: Camera = Camera.make(
            eye=(0.0, 0.0, 5.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
            fovy=45.0, width=256, height=256,
        )
        self.lights: List[Light] = []
        self.background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
        self.ambience: Tuple[float, float, float] = (0.2, 0.2, 0.2)
        self.max_depth: int = 3
        self._spheres: List[Tuple[np.ndarray, float, Material]] = []
        self._planes: List[Tuple[np.ndarray, np.ndarray, Material]] = []
        self._cylinders: List[Tuple[np.ndarray, np.ndarray, float, float, Material]] = []
        self._meshes: List[TriangleMesh] = []

    # --- authoring API -----------------------------------------------------
    def set_camera(self, eye, center, up, fovy, width, height) -> "Scene":
        self.camera = Camera.make(eye, center, up, fovy, width, height)
        return self

    def add_light(self, position, color) -> "Scene":
        self.lights.append(Light(tuple(position), tuple(color)))
        return self

    def add_sphere(self, center, radius: float, material: Material) -> "Scene":
        self._spheres.append((np.asarray(center, np.float32), float(radius), material))
        return self

    def add_plane(self, center, normal, material: Material) -> "Scene":
        n = np.asarray(normal, np.float64)
        n = (n / np.linalg.norm(n)).astype(np.float32)
        self._planes.append((np.asarray(center, np.float32), n, material))
        return self

    def add_cylinder(self, center, axis, radius: float, height: float,
                     material: Material) -> "Scene":
        a = np.asarray(axis, np.float64)
        a = (a / np.linalg.norm(a)).astype(np.float32)
        self._cylinders.append(
            (np.asarray(center, np.float32), a, float(radius), float(height), material))
        return self

    def add_mesh(self, mesh: TriangleMesh) -> "Scene":
        self._meshes.append(mesh)
        return self

    @property
    def meshes(self) -> List[TriangleMesh]:
        return self._meshes

    # --- packing -----------------------------------------------------------
    def build(self, leaf_size: int = 4, cluster_size: int = 128,
              builder: str = "sah") -> SceneData:
        """Pack the scene into device SoA arrays and build the BVH.

        ``leaf_size`` bounds BVH leaf occupancy (reference splits to <= 2,
        mybvh.cpp:270; 4 means fewer lockstep steps; not yet swept on the
        H100, ROADMAP 1.4).
        ``cluster_size`` sets the cluster-cut width for the streaming
        tracer (ops/cluster.py). ``builder`` picks the BVH split rule:
        "sah" (default, tighter bounds) or "median" (reference parity,
        native C++ fast path).
        """
        materials: List[Material] = []
        mat_index: dict = {}

        def mat_id(m: Material) -> int:
            # dedupe identical materials: authoring adds one per object,
            # but many objects share a material — a compact table keeps
            # per-ray material gathers small and shrinks the
            # differentiable mat_* leaves
            key = (tuple(m.ambient), tuple(m.diffuse), tuple(m.specular),
                   float(m.mirror), float(m.shininess), bool(m.shadowable))
            if key not in mat_index:
                mat_index[key] = len(materials)
                materials.append(m)
            return mat_index[key]

        # spheres / planes
        s_center = np.zeros((len(self._spheres), 3), np.float32)
        s_radius = np.zeros((len(self._spheres),), np.float32)
        s_mat = np.zeros((len(self._spheres),), np.int32)
        for i, (c, r, m) in enumerate(self._spheres):
            s_center[i], s_radius[i], s_mat[i] = c, r, mat_id(m)

        p_center = np.zeros((len(self._planes), 3), np.float32)
        p_normal = np.zeros((len(self._planes), 3), np.float32)
        p_mat = np.zeros((len(self._planes),), np.int32)
        for i, (c, n, m) in enumerate(self._planes):
            p_center[i], p_normal[i], p_mat[i] = c, n, mat_id(m)

        nc = len(self._cylinders)
        c_center = np.zeros((nc, 3), np.float32)
        c_axis = np.zeros((nc, 3), np.float32)
        c_radius = np.zeros((nc,), np.float32)
        c_height = np.zeros((nc,), np.float32)
        c_mat = np.zeros((nc,), np.int32)
        for i, (c, a, r, h, m) in enumerate(self._cylinders):
            c_center[i], c_axis[i], c_radius[i], c_height[i], c_mat[i] = (
                c, a, r, h, mat_id(m))

        # meshes -> global flat arrays with rebased indices
        # (the pack loop of build_Data, mytracer.cpp:221-294, redone in NumPy)
        vtx_pos, vtx_nrm = [], []
        tri_vidx, tri_uvidx, tri_mat, tri_flags, tri_tex = [], [], [], [], []
        uv_u, uv_v = [], []
        texels = []
        vbase = ubase = 0
        tex_offset = 0
        for mesh in self._meshes:
            mid = mat_id(mesh.material)
            T = mesh.n_triangles
            vtx_pos.append(mesh.vertices)
            vtx_nrm.append(mesh.vertex_normals)
            tri_vidx.append(mesh.triangles.astype(np.int64) + vbase)
            tri_mat.append(np.full(T, mid, np.int32))
            tri_flags.append(np.full(T, mesh.draw_mode, np.int32))
            if mesh.has_texture:
                tri_uvidx.append(mesh.uv_indices.astype(np.int64) + ubase)
                uv_u.append(mesh.u_coords)
                uv_v.append(mesh.v_coords)
                ubase += mesh.u_coords.shape[0]
                th, tw = mesh.texture.shape[:2]
                tri_tex.append(np.tile([[tw, th, tex_offset]], (T, 1)).astype(np.int64))
                texels.append(mesh.texture.reshape(-1, 3))
                tex_offset += tw * th
            else:
                tri_uvidx.append(np.zeros((T, 3), np.int64))
                tri_tex.append(np.tile([[-1, -1, 0]], (T, 1)).astype(np.int64))
            vbase += mesh.n_vertices

        def cat(parts, empty_shape, dtype):
            if parts:
                return np.concatenate(parts, axis=0).astype(dtype)
            return np.zeros(empty_shape, dtype)

        vertex_pos = cat(vtx_pos, (0, 3), np.float32)
        vertex_normal = cat(vtx_nrm, (0, 3), np.float32)
        tri_vidx_a = cat(tri_vidx, (0, 3), np.int32)
        tri_uvidx_a = cat(tri_uvidx, (0, 3), np.int32)
        tri_mat_a = cat(tri_mat, (0,), np.int32)
        tri_flags_a = cat(tri_flags, (0,), np.int32)
        tri_tex_a = cat(tri_tex, (0, 3), np.int32)
        uv_u_a = cat(uv_u, (0,), np.float32)
        uv_v_a = cat(uv_v, (0,), np.float32)
        texels_a = cat(texels, (0, 3), np.float32)
        if uv_u_a.shape[0] == 0:
            uv_u_a = np.zeros((1,), np.float32)
            uv_v_a = np.zeros((1,), np.float32)
        if texels_a.shape[0] == 0:
            texels_a = np.zeros((1, 3), np.float32)

        # BVH over all triangles (physically permute per leaf partition,
        # like initSoA's index-triple swaps, mybvh.cpp:497-503)
        n_tris = tri_vidx_a.shape[0]
        max_leaf = 2
        if n_tris > 0:
            p0 = vertex_pos[tri_vidx_a[:, 0]]
            p1 = vertex_pos[tri_vidx_a[:, 1]]
            p2 = vertex_pos[tri_vidx_a[:, 2]]
            tree = bvh_mod.build_bvh(p0, p1, p2, leaf_size=leaf_size,
                                     builder=builder)
            perm = tree.order
            tri_vidx_a = tri_vidx_a[perm]
            tri_uvidx_a = tri_uvidx_a[perm]
            tri_mat_a = tri_mat_a[perm]
            tri_flags_a = tri_flags_a[perm]
            tri_tex_a = tri_tex_a[perm]
            bvh_arrays = (tree.bbmin, tree.bbmax, tree.first, tree.count,
                          tree.entry, tree.skip)
            max_leaf = tree.max_leaf
            # per-node triangle ranges, bottom-up (children always have
            # larger indices than their parent, so one reverse sweep
            # suffices); only LEAF first/count are trusted — internal
            # nodes derive their range from their children
            nn = tree.bbmin.shape[0]
            node_lo = np.zeros(nn, np.int64)
            node_hi = np.zeros(nn, np.int64)
            tleft = tree.left
            for n in range(nn - 1, -1, -1):
                if tleft[n] < 0:
                    node_lo[n] = tree.first[n]
                    node_hi[n] = tree.first[n] + tree.count[n]
                else:
                    node_lo[n] = node_lo[tleft[n]]
                    node_hi[n] = node_hi[tleft[n] + 1]
        else:
            bvh_arrays = (
                np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.zeros((1,), np.int32), np.zeros((1,), np.int32),
                np.full((8, 1), -1, np.int32), np.full((8, 1), -1, np.int32),
            )
            node_lo = np.zeros(1, np.int64)
            node_hi = np.zeros(1, np.int64)

        # packed traversal mirrors (see SceneData docstring)
        bbmin_a, bbmax_a, first_a, count_a, entry_a, skip_a = bvh_arrays
        nodes_packed = np.concatenate(
            [bbmin_a.astype(np.float32), bbmax_a.astype(np.float32),
             first_a.astype(np.int32).view(np.float32)[:, None],
             count_a.astype(np.int32).view(np.float32)[:, None]],
            axis=1,
        )
        links_packed = np.stack(
            [entry_a.reshape(-1), skip_a.reshape(-1)], axis=1
        ).astype(np.int32)

        # cluster cut for the streaming tracer (ops/cluster.py)
        cl_M = int(cluster_size)
        if n_tris > 0:
            from myraytracer_tpu.ops.cluster import build_clusters

            # per-tri bounds in leaf order feed the SA-optimal DP cut
            q0 = vertex_pos[tri_vidx_a[:, 0]]
            q1 = vertex_pos[tri_vidx_a[:, 1]]
            q2 = vertex_pos[tri_vidx_a[:, 2]]
            tbmin = np.minimum(np.minimum(q0, q1), q2)
            tbmax = np.maximum(np.maximum(q0, q1), q2)
            cl_first, cl_count, cl_bbmin, cl_bbmax = build_clusters(
                tree, n_tris, cl_M, tri_bounds=(tbmin, tbmax))
        else:
            cl_first = np.zeros((1,), np.int32)
            cl_count = np.zeros((1,), np.int32)
            cl_bbmin = np.zeros((1, 3), np.float32)
            cl_bbmax = np.zeros((1, 3), np.float32)

        # material table
        if not materials:
            materials.append(Material())
        amb = np.stack([np.asarray(m.ambient, np.float32) for m in materials])
        dif = np.stack([np.asarray(m.diffuse, np.float32) for m in materials])
        spc = np.stack([np.asarray(m.specular, np.float32) for m in materials])
        mir = np.asarray([m.mirror for m in materials], np.float32)
        shi = np.asarray([m.shininess for m in materials], np.float32)
        shd = np.asarray([1.0 if m.shadowable else 0.0 for m in materials], np.float32)

        lp = np.asarray([l.position for l in self.lights], np.float32).reshape(-1, 3)
        lc = np.asarray([l.color for l in self.lights], np.float32).reshape(-1, 3)
        # static dead-light culling: a light whose color is exactly zero
        # contributes nothing to any pixel (its diffuse/specular terms are
        # multiplied by the color), yet would still trace a full [R]
        # shadow-ray batch per Whitted segment. Cull it at build — the
        # static analogue of the mirror-free live_depth trim below.
        # (Fidelity fits drive fill lights to zero on several golden
        # scenes; a user who wants to OPTIMIZE a dark light's color must
        # seed it nonzero, since culling removes it from the pytree.)
        if len(lc):
            live = np.any(lc != 0.0, axis=1)
            lp, lc = lp[live], lc[live]

        return SceneData(
            sphere_center=_f32(s_center), sphere_radius=_f32(s_radius), sphere_mat=_i32(s_mat),
            plane_center=_f32(p_center), plane_normal=_f32(p_normal), plane_mat=_i32(p_mat),
            cyl_center=_f32(c_center), cyl_axis=_f32(c_axis),
            cyl_radius=_f32(c_radius), cyl_height=_f32(c_height), cyl_mat=_i32(c_mat),
            vertex_pos=_f32(vertex_pos), vertex_normal=_f32(vertex_normal),
            tri_vidx=_i32(tri_vidx_a), tri_uvidx=_i32(tri_uvidx_a),
            tri_mat=_i32(tri_mat_a), tri_flags=_i32(tri_flags_a), tri_tex=_i32(tri_tex_a),
            uv_u=_f32(uv_u_a), uv_v=_f32(uv_v_a), texels=_f32(texels_a),
            mat_ambient=_f32(amb), mat_diffuse=_f32(dif), mat_specular=_f32(spc),
            mat_mirror=_f32(mir), mat_shininess=_f32(shi), mat_shadowable=_f32(shd),
            light_pos=_f32(lp), light_color=_f32(lc),
            background=_f32(self.background), ambience=_f32(self.ambience),
            bvh_bbmin=_f32(bvh_arrays[0]), bvh_bbmax=_f32(bvh_arrays[1]),
            bvh_first=_i32(bvh_arrays[2]), bvh_count=_i32(bvh_arrays[3]),
            bvh_entry=_i32(bvh_arrays[4]), bvh_skip=_i32(bvh_arrays[5]),
            bvh_nodes_packed=_f32(nodes_packed), bvh_links_packed=_i32(links_packed),
            bvh_lo=_i32(node_lo), bvh_hi=_i32(node_hi),
            cl_first=_i32(cl_first), cl_count=_i32(cl_count),
            cl_bbmin=_f32(cl_bbmin), cl_bbmax=_f32(cl_bbmax), cl_M=cl_M,
            max_depth=int(self.max_depth), max_leaf=int(max_leaf),
            # mirror-free scenes provably never spawn segment 1+
            live_depth=(1 if (len(mir) == 0 or float(np.max(mir)) == 0.0)
                        else int(self.max_depth) + 1),
            has_textures=bool(len(tri_tex_a) and np.any(np.asarray(tri_tex_a)[:, 0] > 0)),
        )
