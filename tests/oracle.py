"""Independent scalar NumPy reference renderer (the test oracle).

Deliberately written in the reference's per-ray recursive style — plain
Python loops, no JAX, no shared code with the framework's vectorized
path — so it serves as a second implementation for cross-backend
agreement testing, the validation strategy the reference itself relies on
(SURVEY.md §4: CPU and GPU "act as the other's oracle").

Integrator semantics mirror the visible GPU twin
(mytracer_gpu.cu:237-312): (1-m)*local + m*chain, weight *= m,
miss adds weight*background.
"""

from __future__ import annotations

import numpy as np

EPS_HIT = 1e-5
EPS_OFFSET = 1e-4


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _hit_sphere(o, d, c, r):
    oc = o - c
    a = d @ d
    b = 2 * oc @ d
    cc = oc @ oc - r * r
    disc = b * b - 4 * a * cc
    if disc < 0:
        return np.inf
    sq = np.sqrt(disc)
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    t = t0 if t0 > EPS_HIT else t1
    return t if t > EPS_HIT else np.inf


def _hit_plane(o, d, c, n):
    cos = n @ d
    if abs(cos) < 1e-9:
        return np.inf
    t = (n @ c - n @ o) / cos
    return t if t > EPS_HIT else np.inf


def _hit_cylinder(o, d, c, u, r, h):
    oc = o - c
    d_par = d @ u
    oc_par = oc @ u
    av = d - d_par * u
    bv = oc - oc_par * u
    a = av @ av
    if a < 1e-12:
        return np.inf
    b = 2 * (av @ bv)
    cc = bv @ bv - r * r
    disc = b * b - 4 * a * cc
    if disc < 0:
        return np.inf
    sq = np.sqrt(disc)
    for t in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
        if t > EPS_HIT and abs(oc_par + t * d_par) <= h / 2:
            return t
    return np.inf


def _hit_triangle(o, d, p0, p1, p2):
    """Cramer's-rule solve; returns (t, alpha, beta) or (inf, 0, 0)."""
    m = np.stack([p0 - p2, p1 - p2, -d], axis=1)
    det = np.linalg.det(m)
    if abs(det) < 1e-10:
        return np.inf, 0.0, 0.0
    rhs = o - p2
    sol = np.linalg.solve(m, rhs)
    alpha, beta, t = sol
    gamma = 1.0 - alpha - beta
    if t <= EPS_HIT:
        return np.inf, 0.0, 0.0
    if not (0 <= alpha <= 1 and 0 <= beta <= 1 and 0 <= gamma <= 1):
        return np.inf, 0.0, 0.0
    return t, alpha, beta


class OracleRenderer:
    """Renders a built SceneData + Camera with scalar loops."""

    def __init__(self, scene, camera):
        import numpy as _np

        g = lambda a: _np.asarray(a)
        self.s = scene
        self.cam = camera
        self.sphere_center = g(scene.sphere_center)
        self.sphere_radius = g(scene.sphere_radius)
        self.sphere_mat = g(scene.sphere_mat)
        self.plane_center = g(scene.plane_center)
        self.plane_normal = g(scene.plane_normal)
        self.plane_mat = g(scene.plane_mat)
        self.cyl_center = g(scene.cyl_center)
        self.cyl_axis = g(scene.cyl_axis)
        self.cyl_radius = g(scene.cyl_radius)
        self.cyl_height = g(scene.cyl_height)
        self.cyl_mat = g(scene.cyl_mat)
        self.vp = g(scene.vertex_pos).astype(np.float64)
        self.vn = g(scene.vertex_normal).astype(np.float64)
        self.tv = g(scene.tri_vidx)
        self.tuv = g(scene.tri_uvidx)
        self.tmat = g(scene.tri_mat)
        self.tflags = g(scene.tri_flags)
        self.ttex = g(scene.tri_tex)
        self.uu = g(scene.uv_u)
        self.vv = g(scene.uv_v)
        self.texels = g(scene.texels)
        self.mat = {
            "ambient": g(scene.mat_ambient),
            "diffuse": g(scene.mat_diffuse),
            "specular": g(scene.mat_specular),
            "mirror": g(scene.mat_mirror),
            "shininess": g(scene.mat_shininess),
            "shadowable": g(scene.mat_shadowable),
        }
        self.light_pos = g(scene.light_pos)
        self.light_color = g(scene.light_color)
        self.background = g(scene.background)
        self.ambience = g(scene.ambience)
        self.max_depth = scene.max_depth

    # --- closest hit over everything ---------------------------------------
    def intersect_scene(self, o, d):
        best = (np.inf, None, None)  # t, kind, idx
        for i in range(self.sphere_center.shape[0]):
            t = _hit_sphere(o, d, self.sphere_center[i], self.sphere_radius[i])
            if t < best[0]:
                best = (t, "sphere", i)
        for i in range(self.plane_center.shape[0]):
            t = _hit_plane(o, d, self.plane_center[i], self.plane_normal[i])
            if t < best[0]:
                best = (t, "plane", i)
        for i in range(self.cyl_center.shape[0]):
            t = _hit_cylinder(o, d, self.cyl_center[i], self.cyl_axis[i],
                              self.cyl_radius[i], self.cyl_height[i])
            if t < best[0]:
                best = (t, "cyl", i)
        if self.tv.shape[0]:
            t, i = self._hit_tris_batched(o, d)
            if t < best[0]:
                best = (t, "tri", i)
        return best

    def _hit_tris_batched(self, o, d):
        """All-triangle closest hit for one ray, vectorized over triangles.

        Cramer's rule via explicit determinants (NumPy, float64) — still an
        implementation independent of the JAX path.
        """
        p0 = self.vp[self.tv[:, 0]]
        p1 = self.vp[self.tv[:, 1]]
        p2 = self.vp[self.tv[:, 2]]
        c1 = p0 - p2
        c2 = p1 - p2
        c3 = -d[None, :].repeat(p0.shape[0], 0)
        c4 = o[None, :] - p2

        def det(a, b, c):
            return (
                a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
                - b[:, 0] * (a[:, 1] * c[:, 2] - a[:, 2] * c[:, 1])
                + c[:, 0] * (a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1])
            )

        s = det(c1, c2, c3)
        ok = np.abs(s) > 1e-10
        s_safe = np.where(ok, s, 1.0)
        t = det(c1, c2, c4) / s_safe
        al = det(c4, c2, c3) / s_safe
        be = det(c1, c4, c3) / s_safe
        ga = 1.0 - al - be
        ok &= (t > EPS_HIT) & (al >= 0) & (al <= 1) & (be >= 0) & (be <= 1) & (ga >= 0) & (ga <= 1)
        t = np.where(ok, t, np.inf)
        i = int(np.argmin(t))
        return float(t[i]), i

    def candidate_ts(self, o, d):
        """ALL positive hit distances along a ray, sorted ascending.

        Used to certify ambiguous pixels: when the two closest hits are
        within fp32 resolution of each other (e.g. a ray passing exactly
        through a mesh edge shared by two triangles), the closest-hit
        winner — and therefore the pixel color — is tie-broken
        arbitrarily, and a full-image comparison must not count such a
        pixel as a disagreement.
        """
        ts = []
        for i in range(self.sphere_center.shape[0]):
            ts.append(_hit_sphere(o, d, self.sphere_center[i], self.sphere_radius[i]))
        for i in range(self.plane_center.shape[0]):
            ts.append(_hit_plane(o, d, self.plane_center[i], self.plane_normal[i]))
        for i in range(self.cyl_center.shape[0]):
            ts.append(_hit_cylinder(o, d, self.cyl_center[i], self.cyl_axis[i],
                                    self.cyl_radius[i], self.cyl_height[i]))
        if self.tv.shape[0]:
            p0 = self.vp[self.tv[:, 0]]
            p1 = self.vp[self.tv[:, 1]]
            p2 = self.vp[self.tv[:, 2]]
            c1 = p0 - p2
            c2 = p1 - p2
            c3 = -d[None, :].repeat(p0.shape[0], 0)
            c4 = o[None, :] - p2

            def det(a, b, c):
                return (
                    a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
                    - b[:, 0] * (a[:, 1] * c[:, 2] - a[:, 2] * c[:, 1])
                    + c[:, 0] * (a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1])
                )

            s = det(c1, c2, c3)
            ok = np.abs(s) > 1e-10
            s_safe = np.where(ok, s, 1.0)
            t = det(c1, c2, c4) / s_safe
            al = det(c4, c2, c3) / s_safe
            be = det(c1, c4, c3) / s_safe
            ga = 1.0 - al - be
            ok &= (t > EPS_HIT) & (al >= 0) & (al <= 1) & (be >= 0) & (be <= 1) & (ga >= 0) & (ga <= 1)
            ts.extend(np.where(ok, t, np.inf).tolist())
        ts = sorted(t for t in ts if np.isfinite(t))
        return ts

    def is_tie_pixel(self, x, y, rel=1e-5):
        """True when the closest hit through pixel (x, y) is ambiguous:
        two candidate hits within relative ``rel`` in t."""
        eye, d = self._ray(x, y)
        ts = self.candidate_ts(eye, d)
        return len(ts) >= 2 and ts[1] <= ts[0] * (1.0 + rel)

    def is_ill_conditioned_pixel(self, x, y, delta, eps=0.25):
        """True when the observed fp32-vs-fp64 color ``delta`` is within
        the color variation of a quarter-pixel neighborhood — i.e. the
        pixel's color is ILL-CONDITIONED at ``delta`` scale.

        The primary-ray tie certificate above only covers closest-hit
        ambiguity on the FIRST segment; fp32-vs-fp64 divergence also
        happens where shadow or mirror rays graze a silhouette (the
        occlusion bit or bounce hit flips — the documented caveat of the
        fixed-hit-topology design, SURVEY.md §7) and in steep smooth
        gradients where fp32's ~1e-7 relative arithmetic amplifies
        through the Whitted chain. Both cases show up as the oracle's
        OWN color moving by >= delta under a sub-pixel ray jitter:
        discontinuities jump by far more, steep gradients by a
        proportional amount. Flat interior pixels (where the jittered
        color barely moves) remain strictly checked.
        """
        base = self.trace(*self._ray(x, y))
        for dx, dy in ((eps, 0), (-eps, 0), (0, eps), (0, -eps)):
            c = self.trace(*self._ray(x + dx, y + dy))
            if float(np.abs(c - base).max()) >= delta:
                return True
        return False

    def _resolve(self, o, d, t, kind, idx):
        point = o + t * d
        if kind == "sphere":
            n = _normalize(point - self.sphere_center[idx])
            mid = self.sphere_mat[idx]
            diffuse = self.mat["diffuse"][mid]
        elif kind == "plane":
            n = self.plane_normal[idx]
            mid = self.plane_mat[idx]
            diffuse = self.mat["diffuse"][mid]
        elif kind == "cyl":
            u = self.cyl_axis[idx]
            rel = point - self.cyl_center[idx]
            n = _normalize(rel - (rel @ u) * u)
            if n @ d > 0:
                n = -n
            mid = self.cyl_mat[idx]
            diffuse = self.mat["diffuse"][mid]
        else:
            vi = self.tv[idx]
            a, b, c = self.vp[vi[0]], self.vp[vi[1]], self.vp[vi[2]]
            _, al, be = _hit_triangle(o, d, a, b, c)
            ga = 1 - al - be
            if self.tflags[idx] == 1:
                n = al * self.vn[vi[0]] + be * self.vn[vi[1]] + ga * self.vn[vi[2]]
            else:
                n = _normalize(np.cross(b - a, c - a))
            mid = self.tmat[idx]
            diffuse = self.mat["diffuse"][mid]
            W, H, off = self.ttex[idx]
            if W > 0:
                ui = self.tuv[idx]
                u = al * self.uu[ui[0]] + be * self.uu[ui[1]] + ga * self.uu[ui[2]]
                v = al * self.vv[ui[0]] + be * self.vv[ui[1]] + ga * self.vv[ui[2]]
                u = min(max(u, 0.0), 1.0)
                v = min(max(v, 0.0), 1.0)
                px = int(round(u * (W - 1)))
                py = int(round((1 - v) * (H - 1)))
                diffuse = self.texels[off + py * W + px]
        return point, n, mid, diffuse

    def lighting(self, point, normal, view, mid, diffuse_color):
        color = self.ambience * self.mat["ambient"][mid]
        for k in range(self.light_pos.shape[0]):
            lp, lc = self.light_pos[k], self.light_color[k]
            l_dir = _normalize(lp - point)
            diff = max(0.0, normal @ l_dir)
            spec = 0.0
            if diff > 0:
                r = _normalize(2 * (l_dir @ normal) * normal - l_dir)
                spec = max(0.0, r @ view) ** self.mat["shininess"][mid]
            shadow = False
            if self.mat["shadowable"][mid] > 0.5:
                sd = np.linalg.norm(lp - point)
                so = point + EPS_OFFSET * l_dir
                t, kind, _ = self.intersect_scene(so, l_dir)
                shadow = kind is not None and 0 < t < sd
            if not shadow:
                color = color + lc * (
                    diffuse_color * diff + self.mat["specular"][mid] * spec
                )
        return color

    def trace(self, o, d):
        t, kind, idx = self.intersect_scene(o, d)
        if kind is None:
            return self.background.copy()
        point, n, mid, dc = self._resolve(o, d, t, kind, idx)
        m = self.mat["mirror"][mid]
        color = (1 - m) * self.lighting(point, n, -d, mid, dc)
        weight = m
        depth = 0
        cur_d = d
        while depth < self.max_depth and weight > 0:
            refl = cur_d - 2 * (cur_d @ n) * n
            o2 = point + EPS_OFFSET * refl
            t, kind, idx = self.intersect_scene(o2, refl)
            if kind is None:
                color = color + weight * self.background
                break
            point, n, mid, dc = self._resolve(o2, refl, t, kind, idx)
            m = self.mat["mirror"][mid]
            color = color + weight * (1 - m) * self.lighting(point, n, -refl, mid, dc)
            weight *= m
            cur_d = refl
            depth += 1
        return color

    def _ray(self, x, y):
        """Primary ray through fractional pixel coords (scalar twin of
        models/camera.Camera.primary_rays)."""
        import math

        cam = self.cam
        eye = np.asarray(cam.eye, np.float64)
        view = _normalize(np.asarray(cam.center, np.float64) - eye)
        right = _normalize(np.cross(view, np.asarray(cam.up, np.float64)))
        up = np.cross(right, view)
        tan_half = math.tan(math.radians(cam.fovy) / 2)
        aspect = cam.width / cam.height
        u = ((x + 0.5) / cam.width) * 2 - 1
        v = 1 - ((y + 0.5) / cam.height) * 2
        return eye, _normalize(view + u * tan_half * aspect * right + v * tan_half * up)

    def render(self):
        cam = self.cam
        W, H = cam.width, cam.height
        img = np.zeros((H, W, 3))
        for y in range(H):
            for x in range(W):
                eye, d = self._ray(x, y)
                img[y, x] = np.minimum(self.trace(eye, d), 1.0)
        return img

    def render_aa(self, img1=None, subp=4, threshold=0.02):
        """Adaptive-supersampling second pass, per the reference rule
        (mytracer_gpu.cu:162-229): for every NON-BORDER pixel whose
        4-neighborhood squared-color deviation in the pass-1 copy exceeds
        ``threshold``, re-shoot subp x subp stratified rays at cell
        centers, average, clamp. Unbounded (no compaction budget) —
        the exact semantics render_aa's static budget must reproduce.
        """
        if img1 is None:
            img1 = self.render()
        H, W = img1.shape[:2]
        out = img1.copy()
        steps = (np.arange(subp) / subp) - 0.5 + 1.0 / (2.0 * subp)
        for y in range(1, H - 1):
            for x in range(1, W - 1):
                c = img1[y, x]
                dev = sum(
                    float(((c - img1[yy, xx]) ** 2).sum())
                    for yy, xx in ((y, x - 1), (y, x + 1), (y - 1, x), (y + 1, x))
                )
                if dev > threshold:
                    acc = np.zeros(3)
                    for oy in steps:
                        for ox in steps:
                            eye, d = self._ray(x + ox, y + oy)
                            acc += self.trace(eye, d)
                    out[y, x] = np.minimum(acc / (subp * subp), 1.0)
        return out


def check_pixels(img, scene, camera, n, seed, atol, quantized=False):
    """Compare a rendered image with the oracle on n sampled pixels.

    Pixels whose closest hit is an fp32 tie (:meth:`is_tie_pixel`), or
    whose oracle color moves by at least the observed difference under a
    quarter-pixel jitter (:meth:`is_ill_conditioned_pixel`), are
    ill-posed at fp32: they are counted as skipped, not as passed.
    ``quantized``: ``img`` came from an 8-bit PNG, so the oracle color is
    rounded the same way and one 8-bit step is added to ``atol`` for the
    rounding of the two sides. Raises AssertionError on any other pixel
    off by more than the tolerance.

    Returns (checked, skipped, max error over the checked pixels).
    """
    orc = OracleRenderer(scene, camera)
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, camera.width, n)
    ys = rng.integers(0, camera.height, n)
    tol = atol + (1.0 / 255.0 if quantized else 0.0)
    skipped, worst, bad = 0, 0.0, []
    for x, y in zip(xs, ys):
        want = np.minimum(orc.trace(*orc._ray(x, y)), 1.0)
        if quantized:
            want = np.floor(np.clip(want, 0.0, 1.0) * 255.0 + 0.5) / 255.0
        err = float(np.abs(np.asarray(img[y, x], np.float64) - want).max())
        if err <= tol:
            worst = max(worst, err)
        elif orc.is_tie_pixel(x, y) or orc.is_ill_conditioned_pixel(x, y,
                                                                     err):
            skipped += 1
        else:
            bad.append((int(x), int(y), err))
    if bad:
        raise AssertionError(
            f"{len(bad)} of {n} pixels differ from the fp64 oracle by more "
            f"than {tol:.5f}: {bad[:8]}")
    return n - skipped, skipped, worst

