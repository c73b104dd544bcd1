"""The XLA forward path against the fp64 scalar oracle on scene variants
that exercise every hit kind and shading feature: triangle-only scenes
(Phong and flat normals, one and two lights, the mirror chain),
analytic primitives (spheres, planes, cylinders, tri-less scenes),
mixed kinds, textures, lightless scenes and large material tables.
"""

import numpy as np
import pytest

from myraytracer_tpu.models.material import Material
from myraytracer_tpu.models.mesh import FLAT, PHONG, TriangleMesh
from myraytracer_tpu.models.scene import Scene
from myraytracer_tpu.ops.render import render
from myraytracer_tpu.scenes.shapes import uv_sphere
from oracle import check_pixels

ATOL = 4e-3         # test_golden.py: fp32 render vs fp64 oracle
MIRROR_ATOL = 6e-3  # test_golden.py, mirror chains accumulate more error


def tri_scene(mirror=0.0, phong=True, two_lights=True, lights=True,
              w=32, h=32):
    s = Scene()
    s.set_camera(eye=(0, 0.8, 4.5), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=w, height=h)
    if lights:
        s.add_light((2, 4, 3), (0.7, 0.7, 0.65))
        if two_lights:
            s.add_light((-3, 2, 1), (0.3, 0.2, 0.2))
    s.ambience = (0.2, 0.2, 0.2)
    s.background = (0.05, 0.1, 0.2)
    s.max_depth = 2
    v, f = uv_sphere(0.7, 8, 12, center=(0.6, 0.1, 0))
    s.add_mesh(TriangleMesh(v, f, material=Material(
        diffuse=(0.6, 0.2, 0.2), specular=(0.5, 0.5, 0.5), shininess=30,
        mirror=mirror), draw_mode=PHONG if phong else FLAT))
    v2, f2 = uv_sphere(0.5, 6, 9, center=(-0.8, -0.1, 0.3))
    s.add_mesh(TriangleMesh(v2, f2, material=Material(
        diffuse=(0.2, 0.5, 0.3), specular=(0.2, 0.2, 0.2), shininess=8),
        draw_mode=FLAT))
    fv = np.asarray([[-3, -0.9, -3], [3, -0.9, -3], [3, -0.9, 3],
                     [-3, -0.9, 3]], np.float32)
    ff = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    s.add_mesh(TriangleMesh(fv, ff, material=Material(
        diffuse=(0.45, 0.45, 0.45), mirror=mirror * 0.5)))
    return s


def mixed_scene(mirror=0.0, cyl=True, tris=True, w=40, h=40):
    """Triangles + sphere + plane (+ cylinder): every hit kind on screen."""
    s = Scene()
    s.set_camera(eye=(0, 1.2, 5.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=55, width=w, height=h)
    s.add_light((3, 5, 4), (0.8, 0.75, 0.7))
    s.add_light((-2, 3, 2), (0.25, 0.25, 0.35))
    s.ambience = (0.15, 0.15, 0.18)
    s.background = (0.04, 0.07, 0.12)
    s.max_depth = 2
    s.add_sphere((-1.1, 0.1, 0.4), 0.6, Material(
        diffuse=(0.2, 0.3, 0.7), specular=(0.6, 0.6, 0.6), shininess=40,
        mirror=mirror))
    s.add_plane((0, -0.9, 0), (0, 1, 0), Material(
        diffuse=(0.5, 0.5, 0.45), mirror=mirror * 0.5))
    if cyl:
        s.add_cylinder((1.6, -0.3, -0.5), (0.1, 1, 0.15), 0.35, 1.4,
                       Material(diffuse=(0.6, 0.5, 0.2), specular=(0.3,) * 3,
                                shininess=12))
    if tris:
        v, f = uv_sphere(0.55, 7, 11, center=(0.4, 0.0, 0.8))
        s.add_mesh(TriangleMesh(v, f, material=Material(
            diffuse=(0.6, 0.2, 0.2), specular=(0.4,) * 3, shininess=25,
            mirror=mirror), draw_mode=PHONG))
    return s


def textured_scene(w=40, h=40):
    """Two textured quads (odd texture sizes) + an untextured mesh."""
    s = Scene()
    s.set_camera(eye=(0, 0.4, 4.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=w, height=h)
    s.add_light((2, 3, 4), (0.9, 0.85, 0.8))
    s.ambience = (0.25, 0.25, 0.25)
    s.background = (0.1, 0.05, 0.15)

    def quad(cx, cy, size, tex):
        fv = np.asarray([[cx - size, cy - size, 0], [cx + size, cy - size, 0],
                         [cx + size, cy + size, 0], [cx - size, cy + size, 0]],
                        np.float32)
        ff = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        return TriangleMesh(
            fv, ff, material=Material(diffuse=(1, 0, 1), specular=(0.2,) * 3,
                                      shininess=10),
            uv_indices=ff.copy(), u_coords=np.asarray([0, 1, 1, 0], np.float32),
            v_coords=np.asarray([0, 0, 1, 1], np.float32), texture=tex,
            draw_mode=FLAT)

    rng = np.random.RandomState(7)
    s.add_mesh(quad(-0.8, 0.0, 0.7, rng.rand(13, 9, 3).astype(np.float32)))
    s.add_mesh(quad(0.9, 0.2, 0.6, rng.rand(6, 17, 3).astype(np.float32)))
    v, f = uv_sphere(0.35, 6, 9, center=(0.0, -0.5, 1.2))
    s.add_mesh(TriangleMesh(v, f, material=Material(
        diffuse=(0.3, 0.6, 0.3), specular=(0.3,) * 3, shininess=20),
        draw_mode=PHONG))
    return s


def many_materials_scene():
    """A triangle scene plus 70 small spheres, each its own material."""
    s = tri_scene()
    rng = np.random.RandomState(3)
    for i in range(70):
        s.add_sphere((-2.0 + 0.06 * i, 1.2 + 0.1 * np.sin(i), -1.0), 0.05,
                     Material(diffuse=tuple(rng.rand(3))))
    return s


VARIANTS = {
    "tri_phong_two_lights": (lambda: tri_scene(), ATOL),
    "tri_flat_one_light": (lambda: tri_scene(phong=False, two_lights=False),
                           ATOL),
    "tri_mirror_chain": (lambda: tri_scene(mirror=0.4), MIRROR_ATOL),
    "tri_lightless": (lambda: tri_scene(lights=False), ATOL),
    "mixed_with_cylinder": (lambda: mixed_scene(), ATOL),
    "mixed_mirror_chain": (lambda: mixed_scene(mirror=0.35, cyl=False),
                           MIRROR_ATOL),
    "analytic_only": (lambda: mixed_scene(tris=False), ATOL),
    "analytic_only_mirror": (lambda: mixed_scene(mirror=0.3, tris=False),
                             MIRROR_ATOL),
    "textured": (textured_scene, ATOL),
    "many_materials": (many_materials_scene, ATOL),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_oracle(variant):
    make, atol = VARIANTS[variant]
    s = make()
    data = s.build()
    img = np.asarray(render(data, s.camera))
    assert img.shape == (s.camera.height, s.camera.width, 3)
    checked, skipped, _ = check_pixels(img, data, s.camera, 24, 11, atol)
    assert checked >= 20, (variant, skipped)

