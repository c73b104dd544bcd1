"""Cluster-scan triangle intersection: dense streaming instead of a walk.

A pointer-chasing BVH walk spends each step on per-ray gathers. This
module replaces the walk with dense streaming compute:

  build    the median-split BVH is CUT at subtrees holding <= M
           triangles; because the builder stores leaves contiguously
           (ops/bvh.py, mirroring the reference's physical SoA partition,
           mybvh.cpp:497-503), every cluster is a contiguous triangle
           range. Clusters get an AABB and are padded into one dense
           [K, M, 9] corner array.
  trace    a while-loop runs over clusters in build (DFS, spatially
           coherent) order. Per cluster: ONE dynamic-slice fetches the
           [M, 9] block (a single copy shared by the whole ray tile), a
           dense [R] AABB test culls, and a `lax.cond` skips the
           cluster's triangle tests entirely when NO ray in the tile
           touches it — tile-level coherence turns the hierarchy's
           log-factor into a branch. Touched clusters run a dense
           [R, M] Cramer's-rule batch.

Rays in a tile must be spatially coherent for the cond-skip to bite;
ops/render.py tiles the image in 2D blocks for exactly this reason.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from myraytracer_tpu.ops import intersect as isx
from myraytracer_tpu.ops.traverse import TriHit
from myraytracer_tpu.utils import knobs

#: triangles per cluster (dense batch width; multiple of 128 lanes)
CLUSTER_M = 128


def _kappa_rel() -> float:
    """DP-cut per-cluster penalty as a fraction of the root-box SA.

    "auto" (default) = 0.0002. The value is normalized by the root
    surface area, so it transfers across scene scales.
    """
    import os as _o

    raw = _o.environ.get("MRT_CLUSTER_KAPPA", "auto")
    if raw == "auto":
        return 2e-4
    return knobs.env_float("MRT_CLUSTER_KAPPA", 2e-4, lo=1e-8, hi=1.0)


def _dp_cut(tri_bbmin: np.ndarray, tri_bbmax: np.ndarray, m: int):
    """Optimal partition of the leaf order into runs of <= m triangles.

    The scan's cost per (ray tile, touched cluster) visit is FIXED —
    one [M, 9] block fetch plus a full dense [R, M] solve, masked lanes
    included — and a cluster's touch probability is ~proportional to its
    AABB surface area. So the right objective for the cut is simply
    ``minimize sum of cluster-box surface areas`` over all partitions of
    the (spatially coherent, BVH-DFS) leaf order into contiguous runs of
    at most m triangles: an O(T*m) dynamic program, vectorized over the
    window axis. A tiny per-cluster epsilon breaks SA ties toward fewer,
    fuller clusters (less phase-1 work, fewer block fetches).

    Against the subtree cut on the office scene this packs 247 clusters
    at 64% mean fill into ~157 at ~99% with a LOWER total SA — the
    subtree cut wastes 36% of every dense solve on padding lanes.
    """
    T = tri_bbmin.shape[0]
    INF = np.float32(np.inf)
    # sa_w[w-1, i] = surface area of the union box of tris [i, i+w)
    bmin = tri_bbmin.copy()
    bmax = tri_bbmax.copy()
    sa_w = np.full((m, T), INF, np.float32)

    def _sa(bmin, bmax):
        e = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                      + e[:, 2] * e[:, 0])

    sa_w[0] = _sa(bmin, bmax)
    for w in range(2, min(m, T) + 1):
        bmin = np.minimum(bmin[:-1], tri_bbmin[w - 1:])
        bmax = np.maximum(bmax[:-1], tri_bbmax[w - 1:])
        sa_w[w - 1, :T - w + 1] = _sa(bmin, bmax)

    # per-cluster penalty: every cluster costs phase-1 slab work and a
    # sort key, independent of its content. Expressed as a fraction of
    # the ROOT box SA so the knob is scene-scale-free; not yet swept on
    # the H100 (ROADMAP 1.4).
    root_sa = float(_sa(tri_bbmin.min(0)[None], tri_bbmax.max(0)[None])[0])
    krel = _kappa_rel()

    def run_dp(eps):
        # cost[i] = best total SA of a valid partition of tris [0, i)
        cost = np.full(T + 1, INF, np.float32)
        back = np.zeros(T + 1, np.int32)
        cost[0] = 0.0
        ws = np.arange(1, m + 1)
        for i in range(1, T + 1):
            w = ws[:min(i, m)]
            cand = cost[i - w] + sa_w[w - 1, i - w] + eps
            j = int(np.argmin(cand))
            cost[i] = cand[j]
            back[i] = i - int(w[j])
        cuts = []
        i = T
        while i > 0:
            cuts.append((back[i], i))
            i = back[i]
        cuts.reverse()
        return cuts

    eps = np.float32(max(krel * root_sa, 1e-12))
    cuts = run_dp(eps)
    # 128-boundary snap: when K lands just above a multiple of 128,
    # raise kappa until the cut fits it (the SA valley is flat there, so
    # the snap is near-free in solve work). Its reason was the removed
    # Pallas cluster kernel, which padded K to 128 lanes; the XLA scan has
    # no such padding, so the snap only keeps cluster counts stable.
    # A K that already is a multiple of 128 is left alone.
    target = (len(cuts) // 128) * 128
    if target >= 128 and 0 < len(cuts) - target <= 24:
        eps_try = eps
        for _ in range(8):
            eps_try = np.float32(eps_try * 1.35)
            cand = run_dp(eps_try)
            if len(cand) <= target:
                cuts = cand
                break
    first = np.asarray([a for a, _ in cuts], np.int32)
    count = np.asarray([b - a for a, b in cuts], np.int32)
    K = len(cuts)
    cl_bbmin = np.empty((K, 3), np.float32)
    cl_bbmax = np.empty((K, 3), np.float32)
    for k, (a, b) in enumerate(cuts):
        cl_bbmin[k] = tri_bbmin[a:b].min(0)
        cl_bbmax[k] = tri_bbmax[a:b].max(0)
    return first, count, cl_bbmin, cl_bbmax


def build_clusters(bvh, leaf_order_tris: int, m: int = CLUSTER_M,
                   tri_bounds=None):
    """Cut a built BVHArrays into clusters of <= m triangles.

    Returns (first [K], count [K], bbmin [K,3], bbmax [K,3]) in DFS
    order (spatially coherent). Host-side NumPy.

    With ``tri_bounds`` (per-triangle (bbmin, bbmax) in leaf order) the
    default cut is the optimal-partition DP (:func:`_dp_cut`), which
    minimizes total cluster surface area — the kernel's actual cost
    model — instead of respecting subtree boundaries. Set
    MRT_CLUSTER_CUT=subtree to force the round-1 subtree cut.
    """
    mode = knobs.env_choice("MRT_CLUSTER_CUT", "dp", ("dp", "subtree"))
    if tri_bounds is not None and mode == "dp":
        return _dp_cut(np.asarray(tri_bounds[0], np.float32),
                       np.asarray(tri_bounds[1], np.float32), m)
    first, count, left = bvh.first, bvh.count, bvh.left
    bbmin, bbmax = bvh.bbmin, bvh.bbmax

    out = []

    def _range_of(n):
        # (first, count) for any node: leaves store it; internal nodes
        # span [left child's first, right child's end)
        stack = [n]
        lo, hi = None, None
        while stack:
            k = stack.pop()
            if left[k] < 0:
                f, c = first[k], count[k]
                lo = f if lo is None else min(lo, f)
                hi = f + c if hi is None else max(hi, f + c)
            else:
                stack.append(left[k])
                stack.append(left[k] + 1)
        return lo, hi - lo

    stack = [0]
    while stack:
        n = stack.pop()
        lo, cnt = _range_of(n)
        if cnt <= m or left[n] < 0:
            out.append((lo, cnt, bbmin[n], bbmax[n]))
        else:
            stack.append(left[n] + 1)
            stack.append(left[n])

    # ---- fill-merge post-pass: the subtree cut leaves clusters ~64%
    # full on real scenes (office: 247 clusters, mean 81/128), and the
    # dense solve executes all M lanes regardless — ~36% of solve flops
    # test padding. DFS-adjacent clusters cover contiguous triangle
    # ranges, so merging neighbors keeps every cluster a contiguous
    # range; a surface-area guard only accepts merges whose union box
    # isn't much looser than the parts (a loose union would cost more
    # false subgroup touches than the reclaimed lanes save). lam is the
    # allowed SA(union)/(SA(a)+SA(b)) ratio; 0 disables.
    lam = knobs.env_float("MRT_CLUSTER_MERGE_SA", 0.75, lo=0.0, hi=10.0)

    def _sa(bmin, bmax):
        e = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    if lam > 0.0 and len(out) > 1:
        merged = [list(out[0])]
        for lo, cnt, bmin, bmax in out[1:]:
            plo, pcnt, pbmin, pbmax = merged[-1]
            if pcnt + cnt <= m:
                ubmin = np.minimum(pbmin, bmin)
                ubmax = np.maximum(pbmax, bmax)
                if _sa(ubmin, ubmax) <= lam * (_sa(pbmin, pbmax)
                                               + _sa(bmin, bmax)):
                    merged[-1] = [plo, pcnt + cnt, ubmin, ubmax]
                    continue
            merged.append([lo, cnt, bmin, bmax])
        out = [tuple(x) for x in merged]

    K = len(out)
    cl_first = np.asarray([o[0] for o in out], np.int32)
    cl_count = np.asarray([o[1] for o in out], np.int32)
    cl_bbmin = np.stack([o[2] for o in out]).astype(np.float32)
    cl_bbmax = np.stack([o[3] for o in out]).astype(np.float32)
    # DFS pop order above emits left-to-right already (left pushed last)
    return cl_first, cl_count, cl_bbmin, cl_bbmax


def pack_cluster_tris(scene, tri_flat16: jnp.ndarray) -> jnp.ndarray:
    """[K, M, 9] dense per-cluster triangle corners from current verts.

    tri_flat16 is pack_tri_vertices(scene) ([T, 16]); padding slots are
    filled with the degenerate all-zero triangle (never hits).
    """
    K = scene.cl_first.shape[0]
    M = scene.cl_M
    T = scene.n_tris
    tri9 = tri_flat16[:, :9]
    tri9 = jnp.concatenate([tri9, jnp.zeros((M, 9), tri9.dtype)], axis=0)
    # per cluster: slice [first : first+M) (static M, traced start)
    def take(f):
        return jax.lax.dynamic_slice(tri9, (f, 0), (M, 9))

    return jax.vmap(take)(jnp.minimum(scene.cl_first, T))


def pack_cluster_matrices(scene, tri_flat16: jnp.ndarray) -> jnp.ndarray:
    """[K, 10, 4M] per-cluster matrix weights for the Cramer solve.

    The ray-triangle system's determinants are bilinear in per-triangle
    constants and the ray features F = [o, d, w = o x d, 1], so a whole
    cluster's (S, t_num, a_num, b_num) is ONE [R, 10] @ [10, 4M] matmul:

        S     = -(N . d)                      N  = c1 x c2
        t_num =   N . o - (N . p2)            c1 = p0 - p2, c2 = p1 - p2
        a_num =  c2 . w + (p2 x c2) . d
        b_num = -c1 . w + (c1 x p2) . d

    (identities: det[c1,c2,-d] = -d.(c1 x c2); det[o-p2, c2, -d] expands
    via the scalar triple product into w- and d-terms). This is the
    matrix-product form of mymesh.cpp:176-236's solve.
    """
    tris = pack_cluster_tris(scene, tri_flat16)          # [K, M, 9]
    p0, p1, p2 = tris[..., 0:3], tris[..., 3:6], tris[..., 6:9]
    c1 = p0 - p2
    c2 = p1 - p2
    n = jnp.cross(c1, c2)                                # [K, M, 3]
    k2 = jnp.cross(p2, c2)
    k1 = jnp.cross(c1, p2)
    ndp2 = jnp.sum(n * p2, axis=-1)                      # [K, M]

    K, M = tris.shape[0], tris.shape[1]
    W = jnp.zeros((K, 10, 4 * M), tris.dtype)
    # feature rows: 0-2 = o, 3-5 = d, 6-8 = w, 9 = 1
    W = W.at[:, 3:6, 0 * M:1 * M].set(-jnp.swapaxes(n, 1, 2))      # S
    W = W.at[:, 0:3, 1 * M:2 * M].set(jnp.swapaxes(n, 1, 2))       # t_num
    W = W.at[:, 9, 1 * M:2 * M].set(-ndp2)
    W = W.at[:, 6:9, 2 * M:3 * M].set(jnp.swapaxes(c2, 1, 2))      # a_num
    W = W.at[:, 3:6, 2 * M:3 * M].set(jnp.swapaxes(k2, 1, 2))
    W = W.at[:, 6:9, 3 * M:4 * M].set(-jnp.swapaxes(c1, 1, 2))     # b_num
    W = W.at[:, 3:6, 3 * M:4 * M].set(jnp.swapaxes(k1, 1, 2))
    return W


def _ray_features(o, d):
    """[R, 10] ray feature rows: o, d, o x d, 1."""
    w = jnp.cross(o, d)
    ones = jnp.ones(o.shape[:-1] + (1,), o.dtype)
    return jnp.concatenate([o, d, w, ones], axis=-1)


def _cluster_solve_mxu(F, Wk, M):
    """One cluster's (t, alpha, beta, S) as one [R,10]@[10,4M] product."""
    out = jnp.dot(F, Wk, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    s = out[:, 0 * M:1 * M]
    t_num = out[:, 1 * M:2 * M]
    a_num = out[:, 2 * M:3 * M]
    b_num = out[:, 3 * M:4 * M]
    s_ok = jnp.abs(s) > isx.EPS_DET
    inv_s = jnp.where(s_ok, 1.0 / jnp.where(s_ok, s, 1.0), 0.0)
    t = t_num * inv_s
    alpha = a_num * inv_s
    beta = b_num * inv_s
    gamma = 1.0 - alpha - beta
    inside = (
        (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
        & (gamma >= 0) & (gamma <= 1)
    )
    valid = s_ok & (t > isx.EPS_HIT) & inside
    return jnp.where(valid, t, isx.INF)


#: clusters tested per while-loop iteration (amortizes the per-iteration
#: loop overhead over more dense work; not yet swept on the H100)
GROUP = knobs.env_int("MRT_CLUSTER_GROUP", 2, lo=1, hi=64)

#: entry budget for materializing the [R, K] phase-1 mask; larger scenes
#: switch to the chunked/recompute path
STORE_LIMIT = knobs.env_int("MRT_CLUSTER_STORE_LIMIT", 32 * 1024 * 1024,
                            lo=1)


class _State(NamedTuple):
    k: jnp.ndarray
    t: jnp.ndarray
    idx: jnp.ndarray
    done: jnp.ndarray


def intersect_clusters(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_max: Optional[jnp.ndarray] = None,
    any_hit: bool = False,
    active: Optional[jnp.ndarray] = None,
    cl_tris: Optional[jnp.ndarray] = None,
) -> TriHit:
    """Closest (or any) hit via the compacted cluster scan.

    Phase 1 tests every (ray, cluster) AABB pair densely and *compacts*
    the clusters touched by ANY ray in the tile to the front of a static
    index list; phase 2 while-loops over only those, GROUP at a time, so
    untouched clusters cost nothing at all (not even a skipped
    iteration). Contract of traverse.traverse_bvh.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    R = o.shape[0]
    if scene.n_tris == 0:
        return TriHit(jnp.full((R,), -1, jnp.int32), jnp.full((R,), isx.INF))

    if cl_tris is None:
        from myraytracer_tpu.ops.traverse import pack_tri_vertices

        cl_tris = pack_cluster_tris(scene, pack_tri_vertices(scene))

    K = scene.cl_first.shape[0]
    M = scene.cl_M
    use_mxu = cl_tris.shape[1] == 10  # matrices vs raw corners
    F = _ray_features(o, d) if use_mxu else None
    inv_d = 1.0 / d
    t0 = jnp.full((R,), isx.INF) if t_max is None else jnp.asarray(t_max)
    act = jnp.ones((R,), bool) if active is None else active

    cl_first = scene.cl_first
    cl_bbmin = jax.lax.stop_gradient(scene.cl_bbmin)
    cl_bbmax = jax.lax.stop_gradient(scene.cl_bbmax)
    kcount = scene.cl_count

    # ---- phase 1: dense AABB pass + compaction ----
    # For big scenes the [R, K] mask would blow memory; past the limit,
    # compute the reductions chunked and re-derive columns in the loop.
    store_mask = R * K <= STORE_LIMIT

    def aabb_cols(kk_lo, width):
        bmin = jax.lax.dynamic_slice_in_dim(cl_bbmin, kk_lo, width, 0)
        bmax = jax.lax.dynamic_slice_in_dim(cl_bbmax, kk_lo, width, 0)
        h, tm = isx.ray_aabb(
            o[:, None, :], inv_d[:, None, :], bmin[None], bmax[None]
        )
        return h, tm

    if store_mask:
        box_hit, tmin_k = isx.ray_aabb(
            o[:, None, :], inv_d[:, None, :], cl_bbmin[None], cl_bbmax[None]
        )                                               # [R, K]
        ray_touch = box_hit & act[:, None] & (tmin_k <= t0[:, None])
        touched = jnp.any(ray_touch, axis=0)            # [K]
    else:
        CHUNK = min(256, K)
        Kp = ((K + CHUNK - 1) // CHUNK) * CHUNK

        def chunk_stats(c):
            h, tm = aabb_cols(jnp.minimum(c * CHUNK, K - CHUNK), CHUNK)
            tch = h & act[:, None] & (tm <= t0[:, None])
            cnt = jnp.sum(tch, axis=0)
            s = jnp.sum(jnp.where(tch, jnp.maximum(tm, 0.0), 0.0), axis=0)
            return jnp.any(tch, axis=0), cnt, s

        outs = jax.lax.map(chunk_stats, jnp.arange(Kp // CHUNK))
        # chunks overlap at the tail clamp; recomputing columns in the
        # loop keeps results exact, stats only guide ordering
        touched = jnp.zeros((K,), bool)
        cnts = jnp.zeros((K,), jnp.int32)
        sums = jnp.zeros((K,), jnp.float32)
        for c in range(Kp // CHUNK):
            lo = min(c * CHUNK, K - CHUNK)
            touched = touched.at[lo:lo + CHUNK].set(outs[0][c])
            cnts = cnts.at[lo:lo + CHUNK].set(outs[1][c])
            sums = sums.at[lo:lo + CHUNK].set(outs[2][c])
        ray_touch = None
        tmin_k = None
    # compaction order: touched clusters first, FRONT TO BACK by the
    # tile's mean entry distance — early hits shrink t_best so the
    # group-level cond below can skip far clusters outright
    if store_mask:
        mean_tmin = jnp.sum(jnp.where(ray_touch, jnp.maximum(tmin_k, 0.0), 0.0), axis=0)
        mean_tmin = mean_tmin / jnp.maximum(jnp.sum(ray_touch, axis=0), 1)
    else:
        mean_tmin = sums / jnp.maximum(cnts, 1)
    sort_key = jnp.where(touched, mean_tmin, isx.INF)
    order = jnp.argsort(sort_key, stable=True)
    n_touched = jnp.sum(touched.astype(jnp.int32))
    n_groups = (n_touched + GROUP - 1) // GROUP

    # pad the order list so groups can read past n_touched harmlessly
    order_pad = jnp.concatenate(
        [order.astype(jnp.int32), jnp.zeros((GROUP,), jnp.int32)]
    )

    def col_for(kk):
        if store_mask:
            col_hit = jax.lax.dynamic_slice_in_dim(ray_touch, kk, 1, 1)[:, 0]
            col_tmin = jax.lax.dynamic_slice_in_dim(tmin_k, kk, 1, 1)[:, 0]
            return col_hit, col_tmin
        h, tm = aabb_cols(kk, 1)
        return (h[:, 0] & act & (tm[:, 0] <= t0)), tm[:, 0]

    def body(s: _State) -> _State:
        def run_group(args):
            t_best, idx = args
            for g in range(GROUP):
                kk = order_pad[s.k * GROUP + g]
                in_range = (s.k * GROUP + g) < n_touched
                col_hit, col_tmin = col_for(kk)
                touch = col_hit & in_range & (col_tmin <= t_best)
                if any_hit:
                    touch &= idx < 0

                if use_mxu:
                    Wk = jax.lax.dynamic_slice(
                        cl_tris, (kk, 0, 0), (1, 10, 4 * M))[0]
                    t_tri = _cluster_solve_mxu(F, Wk, M)     # [R, M]
                else:
                    tri = jax.lax.dynamic_slice(cl_tris, (kk, 0, 0), (1, M, 9))[0]
                    t_tri, _, _ = isx.ray_triangle(
                        o[:, None, :], d[:, None, :],
                        tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9],
                    )                                        # [R, M]
                slot_ok = (jnp.arange(M, dtype=jnp.int32) < kcount[kk])[None, :]
                t_tri = jnp.where(touch[:, None] & slot_ok, t_tri, isx.INF)
                j = jnp.argmin(t_tri, axis=1)
                t_min = jnp.take_along_axis(t_tri, j[:, None], axis=1)[:, 0]
                better = t_min < t_best
                t_best = jnp.where(better, t_min, t_best)
                idx = jnp.where(better, cl_first[kk] + j.astype(jnp.int32), idx)
            return t_best, idx

        # group-level cull against the evolving t_best: with front-to-back
        # ordering, far clusters drop out once the tile's hits resolve
        any_live = jnp.zeros((), bool)
        for g in range(GROUP):
            kk = order_pad[s.k * GROUP + g]
            in_range = (s.k * GROUP + g) < n_touched
            col_hit, col_tmin = col_for(kk)
            live = col_hit & in_range & (col_tmin <= s.t)
            if any_hit:
                live &= s.idx < 0
            any_live |= jnp.any(live)

        t_best, idx = jax.lax.cond(any_live, run_group, lambda a: a,
                                   (s.t, s.idx))

        done = s.done
        if any_hit:
            done = jnp.all((idx >= 0) | ~act)
        return _State(s.k + 1, t_best, idx, done)

    init = _State(
        k=jnp.zeros((), jnp.int32),
        t=t0,
        idx=jnp.full((R,), -1, jnp.int32),
        done=jnp.zeros((), bool),
    )
    out = jax.lax.while_loop(
        lambda s: (s.k < n_groups) & ~s.done, body, init
    )
    t_hit = jnp.where(out.idx >= 0, out.t, isx.INF)
    return TriHit(out.idx, jax.lax.stop_gradient(t_hit))
