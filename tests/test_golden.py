"""Golden-scene harness: every reference scene builds, renders, and the
vectorized XLA path agrees with the independent scalar oracle on sampled
pixels (SURVEY.md §4: golden-image reproduction + cross-backend
agreement)."""

import math

import numpy as np
import pytest

from myraytracer_tpu.ops.render import render
from myraytracer_tpu.scenes import golden
from oracle import OracleRenderer, _normalize

SCALE = 0.08  # tiny renders: 40x40-ish


def _sample_rays(cam, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, cam.width, n)
    ys = rng.integers(0, cam.height, n)
    eye = np.asarray(cam.eye, np.float64)
    view = _normalize(np.asarray(cam.center, np.float64) - eye)
    right = _normalize(np.cross(view, np.asarray(cam.up, np.float64)))
    up = np.cross(right, view)
    tan_half = math.tan(math.radians(cam.fovy) / 2)
    aspect = cam.width / cam.height
    dirs = []
    for x, y in zip(xs, ys):
        u = ((x + 0.5) / cam.width) * 2 - 1
        v = 1 - ((y + 0.5) / cam.height) * 2
        dirs.append(_normalize(view + u * tan_half * aspect * right + v * tan_half * up))
    return xs, ys, eye, np.asarray(dirs)


@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_scene_builds_and_renders(name):
    builder, _ = golden.GOLDEN_SCENES[name]
    sc = builder(scale=SCALE)
    data = sc.build()
    img = np.asarray(render(data, sc.camera))
    assert img.shape == (sc.camera.height, sc.camera.width, 3)
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 + 1e-6
    assert img.max() > 0.01  # something is visible


@pytest.mark.parametrize(
    "name",
    ["o_01_spheres", "o_02_shadow", "o_04_molecule", "o_05_cube",
     "o_06_mask", "o_07_toon_faces", "o_08_office", "o_09_rings",
     "o_10_pokemon"],
)
@pytest.mark.slow
def test_sampled_pixels_match_oracle(name):
    builder, _ = golden.GOLDEN_SCENES[name]
    sc = builder(scale=SCALE)
    data = sc.build()
    img = np.asarray(render(data, sc.camera))
    orc = OracleRenderer(data, sc.camera)
    xs, ys, eye, dirs = _sample_rays(sc.camera, 20, seed=1)
    for x, y, d in zip(xs, ys, dirs):
        want = np.minimum(orc.trace(eye, d), 1.0)
        got = img[y, x]
        np.testing.assert_allclose(got, want, atol=4e-3,
                                   err_msg=f"{name} pixel ({x},{y})")


@pytest.mark.slow
def test_mirror_scene_oracle_subset():
    # o_03 has max_depth 20; keep the oracle comparison to a few pixels
    sc = golden.scene_03_mirror(scale=SCALE)
    data = sc.build()
    img = np.asarray(render(data, sc.camera))
    orc = OracleRenderer(data, sc.camera)
    xs, ys, eye, dirs = _sample_rays(sc.camera, 6, seed=2)
    for x, y, d in zip(xs, ys, dirs):
        want = np.minimum(orc.trace(eye, d), 1.0)
        np.testing.assert_allclose(img[y, x], want, atol=6e-3)
