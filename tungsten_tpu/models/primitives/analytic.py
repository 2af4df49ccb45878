"""Analytic sphere / disk / cylinder primitives for the wavefront.

The reference intersects these exactly (Sphere.cpp:97-161, Disk.cpp:64-105,
Cylinder.cpp:55-116) and direct-samples spheres by uniform spherical cap
(Sphere.cpp:173-191); rounds 1-3 tessellated them, which made silhouettes
polygonal and sphere emitters noisier than the reference. This module is
the wavefront equivalent: every analytic primitive is tested against every
lane with (A, N) tile math (A = #analytic prims, small), the winner
is min-selected with the same reduction-free one-hot pattern as
ops.gather_bvh, and the result merges with the triangle BVH hit by t.

Identifier space: analytic prims occupy virtual ids [T, T+A) after the T
real triangles; the flattener extends every per-triangle attribute table
(mat / light / media) by A rows so existing gathers work unchanged.
Shading normals and uv are position-dependent — they are carried through
the intersection one-hot (exact reference uv semantics per type) and
override the barycentric path in the integrators' shading-data gather.

Parameter extraction mirrors prepareForRender exactly:
  sphere   : pos = M*0, radius = extractScale().max(), rot for uv
             (Sphere.cpp:285-295)
  disk     : center = M*0, r = max(sx, sz), n = M*(0,1,0) normalized,
             TangentFrame(n), cosApex = cos(cone_angle) (Disk.cpp:315-327)
  cylinder : pos = M*0, axis = up(), radius = 0.5*max(sx, sz),
             halfHeight = 0.5*sy, optional caps (Cylinder.cpp:288-301)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from ...utils.pytree import dataclass as pytree, field

INF = jnp.float32(3.0e38)

SPHERE, DISK, CYLINDER = 0, 1, 2


@pytree
class AnalyticTable:
    ptype: jnp.ndarray  # (A,) int32
    pos: jnp.ndarray  # (A, 3) center / base position
    radius: jnp.ndarray  # (A,)
    inv_rot: jnp.ndarray  # (A, 3, 3) world->local rotation (sphere uv, cyl)
    axis: jnp.ndarray  # (A, 3) disk normal / cylinder axis (unit)
    half_h: jnp.ndarray  # (A,) cylinder half height
    cos_apex: jnp.ndarray  # (A,) disk emission-cone cos (<= -1: none)
    capped: jnp.ndarray  # (A,) bool
    frame_t: jnp.ndarray  # (A, 3) disk TangentFrame tangent
    frame_b: jnp.ndarray  # (A, 3) disk TangentFrame bitangent
    area: jnp.ndarray  # (A,)
    n: int = field(pytree_node=False, default=0)


@pytree
class AnaHit:
    t: jnp.ndarray  # (N,) INF = miss
    k: jnp.ndarray  # (N,) analytic prim index, -1 = miss
    uv: jnp.ndarray  # (N, 2) reference uv at the hit
    ng: jnp.ndarray  # (N, 3) geometric normal at the hit
    back: jnp.ndarray  # (N,) bool hitBackside(data)


def _as_rows(x):
    return x[:, None]  # (A,) -> (A, 1) broadcasting against (N,)


def intersect_analytic(ana: AnalyticTable, o, d, tnear, tfar) -> AnaHit:
    """Closest analytic hit per lane over all A prims, (A, N) vectorized.
    Matches the reference intersectors' accept rules exactly (t in the OPEN
    interval (nearT, farT), nearer-candidate ordering per type)."""
    N = o.shape[0]
    A = ana.n
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    is_sph = _as_rows(ana.ptype == SPHERE)
    is_dsk = _as_rows(ana.ptype == DISK)
    is_cyl = _as_rows(ana.ptype == CYLINDER)
    px_, py_, pz_ = (_as_rows(ana.pos[:, i]) for i in range(3))
    r_ = _as_rows(ana.radius)

    best_t = jnp.broadcast_to(tfar, (A, N))
    t_out = jnp.full((A, N), jnp.inf, jnp.float32)
    u_out = jnp.zeros((A, N), jnp.float32)
    v_out = jnp.zeros((A, N), jnp.float32)
    ngx = jnp.zeros((A, N), jnp.float32)
    ngy = jnp.zeros((A, N), jnp.float32)
    ngz = jnp.zeros((A, N), jnp.float32)
    back = jnp.zeros((A, N), bool)

    # ---- sphere (Sphere.cpp:60-95): |o + t d - c|^2 = r^2 ----------------
    sx, sy, sz = ox - px_, oy - py_, oz - pz_  # (A, N)
    B = sx * dx + sy * dy + sz * dz
    C = sx * sx + sy * sy + sz * sz - r_ * r_
    det_sq = B * B - C
    det = jnp.sqrt(jnp.maximum(det_sq, 0.0))
    t0 = -B - det
    t1 = -B + det
    ok0 = (det_sq >= 0.0) & (t0 > tnear) & (t0 < best_t)
    ok1 = (det_sq >= 0.0) & (t1 > tnear) & (t1 < best_t) & ~ok0
    t_s = jnp.where(ok0, t0, t1)
    hit_s = is_sph & (ok0 | ok1)
    t_out = jnp.where(hit_s, t_s, t_out)
    back = jnp.where(hit_s, ok1, back)
    # normal + uv (Sphere::intersectionInfo): Ng = (p - c)/r; uv from
    # localN = invRot * Ng
    hx = (sx + t_s * dx) / r_
    hy = (sy + t_s * dy) / r_
    hz = (sz + t_s * dz) / r_
    ir = ana.inv_rot  # (A, 3, 3)
    lx = _as_rows(ir[:, 0, 0]) * hx + _as_rows(ir[:, 0, 1]) * hy + _as_rows(ir[:, 0, 2]) * hz
    ly = _as_rows(ir[:, 1, 0]) * hx + _as_rows(ir[:, 1, 1]) * hy + _as_rows(ir[:, 1, 2]) * hz
    lz = _as_rows(ir[:, 2, 0]) * hx + _as_rows(ir[:, 2, 1]) * hy + _as_rows(ir[:, 2, 2]) * hz
    u_sph = jnp.arctan2(ly, lx) * (0.5 / jnp.pi) + 0.5
    u_sph = jnp.where(jnp.isnan(u_sph), 0.0, u_sph)
    v_sph = jnp.arccos(jnp.clip(lz, -1.0, 1.0)) * (1.0 / jnp.pi)
    u_out = jnp.where(hit_s, u_sph, u_out)
    v_out = jnp.where(hit_s, v_sph, v_out)
    ngx = jnp.where(hit_s, hx, ngx)
    ngy = jnp.where(hit_s, hy, ngy)
    ngz = jnp.where(hit_s, hz, ngz)
    best_t = jnp.where(hit_s, t_s, best_t)

    # ---- disk (Disk.cpp:64-86) -------------------------------------------
    nx_, ny_, nz_ = (_as_rows(ana.axis[:, i]) for i in range(3))
    n_dot_w = nx_ * dx + ny_ * dy + nz_ * dz
    t_d = (nx_ * (px_ - ox) + ny_ * (py_ - oy) + nz_ * (pz_ - oz)) / n_dot_w
    qx = ox + t_d * dx - px_
    qy = oy + t_d * dy - py_
    qz = oz + t_d * dz - pz_
    r_sq = qx * qx + qy * qy + qz * qz
    hit_d = is_dsk & (t_d > tnear) & (t_d < best_t) & (r_sq <= r_ * r_)
    t_out = jnp.where(hit_d, t_d, t_out)
    # uv (Disk::intersectionInfo): d = p - center; uv = (atan2(fT.d, fB.d)
    # /2pi + 0.5, |d|/r) — the reference maps angle u and radial v
    ftx, fty, ftz = (_as_rows(ana.frame_t[:, i]) for i in range(3))
    fbx, fby, fbz = (_as_rows(ana.frame_b[:, i]) for i in range(3))
    du = qx * ftx + qy * fty + qz * ftz
    dv = qx * fbx + qy * fby + qz * fbz
    u_dsk = jnp.arctan2(du, dv) * (0.5 / jnp.pi) + 0.5
    v_dsk = jnp.sqrt(r_sq) / r_
    u_out = jnp.where(hit_d, u_dsk, u_out)
    v_out = jnp.where(hit_d, v_dsk, v_out)
    ngx = jnp.where(hit_d, nx_ + 0.0 * t_d, ngx)
    ngy = jnp.where(hit_d, ny_ + 0.0 * t_d, ngy)
    ngz = jnp.where(hit_d, nz_ + 0.0 * t_d, ngz)
    back = jnp.where(hit_d, -n_dot_w < _as_rows(ana.cos_apex), back)
    best_t = jnp.where(hit_d, t_d, best_t)

    # ---- cylinder (Cylinder.cpp:55-116): local frame via invRot ----------
    rel_x, rel_y, rel_z = ox - px_, oy - py_, oz - pz_
    plx = _as_rows(ir[:, 0, 0]) * rel_x + _as_rows(ir[:, 0, 1]) * rel_y + _as_rows(ir[:, 0, 2]) * rel_z
    ply = _as_rows(ir[:, 1, 0]) * rel_x + _as_rows(ir[:, 1, 1]) * rel_y + _as_rows(ir[:, 1, 2]) * rel_z
    plz = _as_rows(ir[:, 2, 0]) * rel_x + _as_rows(ir[:, 2, 1]) * rel_y + _as_rows(ir[:, 2, 2]) * rel_z
    dlx = _as_rows(ir[:, 0, 0]) * dx + _as_rows(ir[:, 0, 1]) * dy + _as_rows(ir[:, 0, 2]) * dz
    dly = _as_rows(ir[:, 1, 0]) * dx + _as_rows(ir[:, 1, 1]) * dy + _as_rows(ir[:, 1, 2]) * dz
    dlz = _as_rows(ir[:, 2, 0]) * dx + _as_rows(ir[:, 2, 1]) * dy + _as_rows(ir[:, 2, 2]) * dz
    inv_r = 1.0 / jnp.maximum(r_, 1e-30)
    hh = _as_rows(ana.half_h)
    p2x, p2y = plx * inv_r, plz * inv_r  # xz plane, scaled to unit circle
    d2x, d2y = dlx * inv_r, dlz * inv_r
    cyl_t = jnp.full((A, N), jnp.inf)
    cyl_ng = (jnp.zeros((A, N)), jnp.zeros((A, N)), jnp.zeros((A, N)))
    cyl_uv = (jnp.zeros((A, N)), jnp.zeros((A, N)))
    cyl_back = jnp.zeros((A, N), bool)
    # caps, +1 then -1 (ray.setFarT ordering preserved by sequential wheres)
    capped_ = _as_rows(ana.capped)
    for sign in (1.0, -1.0):
        t_c = (sign * hh - ply) / dly
        chx = p2x + t_c * d2x
        chy = p2y + t_c * d2y
        ok = (
            is_cyl & capped_ & (jnp.abs(dly) > 1e-6)
            & (t_c > tnear) & (t_c < best_t) & (t_c < cyl_t)
            & (chx * chx + chy * chy < 1.0)
        )
        cyl_t = jnp.where(ok, t_c, cyl_t)
        cyl_ng = tuple(jnp.where(ok, v, g) for v, g in
                       zip((0.0 * t_c, jnp.full_like(t_c, sign), 0.0 * t_c), cyl_ng))
        cyl_uv = (jnp.where(ok, chx * 0.5 + 0.5, cyl_uv[0]),
                  jnp.where(ok, chy * 0.5 + 0.5, cyl_uv[1]))
        cyl_back = jnp.where(ok, sign * dly > 0.0, cyl_back)
    # lateral surface
    a_q = d2x * d2x + d2y * d2y
    b_q = p2x * d2x + p2y * d2y
    c_q = p2x * p2x + p2y * p2y - 1.0
    det_sq_c = b_q * b_q - a_q * c_q
    det_c = jnp.sqrt(jnp.maximum(det_sq_c, 0.0))
    for sign in (1.0, -1.0):
        t_l = (-b_q - sign * det_c) / jnp.where(a_q == 0.0, 1e-30, a_q)
        h_l = ply + dly * t_l
        ok = (
            is_cyl & (det_sq_c >= 0.0)
            & (t_l > tnear) & (t_l < best_t) & (t_l < cyl_t)
            & (h_l >= -hh) & (h_l <= hh)
        )
        lhx = p2x + t_l * d2x
        lhy = p2y + t_l * d2y
        cyl_t = jnp.where(ok, t_l, cyl_t)
        cyl_ng = tuple(jnp.where(ok, v, g) for v, g in
                       zip((lhx, 0.0 * t_l, lhy), cyl_ng))
        # uv: (atan2(n.z, n.x)/2pi + 0.5, h/(2 hh) + 0.5) — intersectionInfo
        u_l = jnp.arctan2(lhy, lhx) * (0.5 / jnp.pi) + 0.5
        v_l = h_l / jnp.maximum(2.0 * hh, 1e-30) + 0.5
        cyl_uv = (jnp.where(ok, u_l, cyl_uv[0]), jnp.where(ok, v_l, cyl_uv[1]))
        cyl_back = jnp.where(ok, sign < 0.0, cyl_back)
    hit_c = is_cyl & jnp.isfinite(cyl_t)
    t_out = jnp.where(hit_c, cyl_t, t_out)
    # rotate local normal back to world: ng_world = rot * n_local =
    # invRot^T * n_local
    wnx = _as_rows(ir[:, 0, 0]) * cyl_ng[0] + _as_rows(ir[:, 1, 0]) * cyl_ng[1] + _as_rows(ir[:, 2, 0]) * cyl_ng[2]
    wny = _as_rows(ir[:, 0, 1]) * cyl_ng[0] + _as_rows(ir[:, 1, 1]) * cyl_ng[1] + _as_rows(ir[:, 2, 1]) * cyl_ng[2]
    wnz = _as_rows(ir[:, 0, 2]) * cyl_ng[0] + _as_rows(ir[:, 1, 2]) * cyl_ng[1] + _as_rows(ir[:, 2, 2]) * cyl_ng[2]
    ngx = jnp.where(hit_c, wnx, ngx)
    ngy = jnp.where(hit_c, wny, ngy)
    ngz = jnp.where(hit_c, wnz, ngz)
    u_out = jnp.where(hit_c, cyl_uv[0], u_out)
    v_out = jnp.where(hit_c, cyl_uv[1], v_out)
    back = jnp.where(hit_c, cyl_back, back)

    # ---- nearest across prims: min + one-hot ------------------------------
    hit_any = jnp.isfinite(t_out)
    tm = jnp.where(hit_any, t_out, jnp.inf)
    tmin = jnp.min(tm, axis=0)  # (N,)
    arange_a = jnp.arange(A, dtype=jnp.int32)[:, None]
    ksel = jnp.min(jnp.where(hit_any & (tm == tmin), arange_a, A), axis=0)
    one = arange_a == ksel
    pick = lambda arr: jnp.sum(jnp.where(one, arr, 0.0), axis=0)
    found = ksel < A
    ng = jnp.stack([pick(ngx), pick(ngy), pick(ngz)], axis=-1)
    nl = jnp.sqrt(jnp.maximum(jnp.sum(ng * ng, axis=-1, keepdims=True), 1e-30))
    return AnaHit(
        t=jnp.where(found, tmin, INF),
        k=jnp.where(found, ksel, -1),
        uv=jnp.stack([pick(u_out), pick(v_out)], axis=-1),
        ng=ng / nl,
        back=jnp.sum(jnp.where(one, back, False), axis=0).astype(bool),
    )


def occluded_analytic(ana: AnalyticTable, o, d, tnear, tfar) -> jnp.ndarray:
    """Any-hit over analytic prims. NB the reference's Disk::occluded is
    one-sided (front side only, Disk.cpp:88-105); sphere/cylinder occlude
    from both sides."""
    h = intersect_analytic(ana, o, d, tnear, tfar)
    k = jnp.maximum(h.k, 0)
    is_disk_hit = (h.k >= 0) & (ana.ptype[k] == DISK)
    n_dot_w = jnp.sum(ana.axis[k] * d, axis=-1)
    blocked = (h.k >= 0) & jnp.where(is_disk_hit, n_dot_w < 0.0, True)
    return blocked


def normal_at(ana: AnalyticTable, k, p) -> jnp.ndarray:
    """Geometric normal of analytic prim k (N,) at surface point p (N, 3).
    Ns = Ng for all three types (intersectionInfo of Sphere.cpp:119,
    Disk.cpp:115, Cylinder.cpp:126). Cylinder cap-vs-lateral is recovered
    geometrically: a surface point with |local y| at the half height and
    radial distance < r is on a cap."""
    k = jnp.clip(k, 0, max(ana.n - 1, 0))
    pos = ana.pos[k]
    r = ana.radius[k]
    ptype = ana.ptype[k]
    rel = p - pos

    n_sph = rel / jnp.maximum(r, 1e-30)[..., None]
    n_dsk = ana.axis[k]

    ir = ana.inv_rot[k]  # (N, 3, 3)
    pl = jnp.einsum("nij,nj->ni", ir, rel)
    rad2 = pl[..., 0] ** 2 + pl[..., 2] ** 2
    hh = ana.half_h[k]
    on_cap = ana.capped[k] & (
        jnp.abs(jnp.abs(pl[..., 1]) - hh) * jnp.maximum(r, 1e-30)
        < jnp.abs(jnp.sqrt(jnp.maximum(rad2, 0.0)) - r) + 1e-7
    )
    n_loc = jnp.where(
        on_cap[..., None],
        jnp.stack([jnp.zeros_like(hh), jnp.sign(pl[..., 1]), jnp.zeros_like(hh)], -1),
        jnp.stack([pl[..., 0], jnp.zeros_like(hh), pl[..., 2]], -1)
        / jnp.maximum(r, 1e-30)[..., None],
    )
    n_cyl = jnp.einsum("nji,nj->ni", ir, n_loc)  # rot = invRot^T

    n = jnp.where(
        (ptype == SPHERE)[..., None], n_sph,
        jnp.where((ptype == DISK)[..., None], n_dsk, n_cyl),
    )
    return n / jnp.sqrt(jnp.maximum(jnp.sum(n * n, -1, keepdims=True), 1e-30))


def hit_geom(scene, prim, p, u, v):
    """(ng, uv) at a hit on `prim` — a triangle id or an analytic virtual id
    >= T. For analytic prims the Hit's (u, v) carry the intersectionInfo uv
    directly (not barycentrics) and the normal is recomputed from p."""
    tri = jnp.maximum(prim, 0)
    w0 = (1.0 - u - v)[..., None]
    uv = (scene.tri_uv0[tri] * w0
          + scene.tri_uv1[tri] * u[..., None]
          + scene.tri_uv2[tri] * v[..., None])
    ng = scene.tri_ng[tri]
    if scene.meta.has_analytic:
        n_tris = scene.tris.v0.shape[0]
        is_a = prim >= n_tris
        ng = jnp.where(is_a[..., None], normal_at(scene.ana, prim - n_tris, p), ng)
        uv = jnp.where(is_a[..., None], jnp.stack([u, v], -1), uv)
    return ng, uv


def _frame_to_global(axis, local):
    """TangentFrame(axis).toGlobal(local) batched (Duff et al. branchless)."""
    s = jnp.where(axis[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + axis[..., 2])
    b = axis[..., 0] * axis[..., 1] * a
    t = jnp.stack(
        [1.0 + s * axis[..., 0] ** 2 * a, s * b, -s * axis[..., 0]], -1
    )
    bt = jnp.stack([b, s + axis[..., 1] ** 2 * a, -axis[..., 1]], -1)
    return (
        t * local[..., 0:1] + bt * local[..., 1:2] + axis * local[..., 2:3]
    )


def sample_direct(ana: AnalyticTable, k, p, u2, u1):
    """Primitive::sampleDirect for analytic prim k (N,) from point p.

    sphere   : uniform spherical cap subtending the sphere, pdf =
               uniformSphericalCapPdf; invalid inside (Sphere.cpp:173-191)
    disk     : uniform point on the disk, front side + emission cone gate,
               pdf = r^2/(cos * pi r^2) (Disk.cpp:177-193)
    cylinder : uniform surface position (caps by area share), pdf =
               r^2/(cos * area) (Cylinder.cpp:152-201)

    Returns (d, dist, pdf, uv, valid) with uv the intersectionInfo uv at the
    lit point (the reference evaluates emission at the shadow-ray hit)."""
    k = jnp.clip(k, 0, max(ana.n - 1, 0))
    ptype = ana.ptype[k]
    pos = ana.pos[k]
    r = ana.radius[k]
    area = ana.area[k]
    ir = ana.inv_rot[k]

    # ---- sphere: cap sample about L = pos - p -----------------------------
    Lv = pos - p
    dist_c = jnp.sqrt(jnp.maximum(jnp.sum(Lv * Lv, -1), 1e-30))
    C = dist_c * dist_c - r * r
    outside = C > 0.0
    cos_max = jnp.sqrt(jnp.maximum(C, 0.0)) / dist_c
    # uniformSphericalCap(xi, cosMax)
    cos_t = cos_max + u2[..., 1] * (1.0 - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = u2[..., 0] * (2.0 * jnp.pi)
    local = jnp.stack([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], -1)
    Ln = Lv / dist_c[..., None]
    d_sph = _frame_to_global(Ln, local)
    B = dist_c * cos_t
    det = jnp.sqrt(jnp.maximum(B * B - C, 0.0))
    t_sph = B - det
    pdf_sph = (0.5 / jnp.pi) / jnp.maximum(1.0 - cos_max, 1e-9)
    # uv at the hit (Sphere::intersectionInfo)
    hp = p + d_sph * t_sph[..., None]
    ng_s = (hp - pos) / jnp.maximum(r, 1e-30)[..., None]
    ln = jnp.einsum("nij,nj->ni", ir, ng_s)
    u_s = jnp.arctan2(ln[..., 1], ln[..., 0]) * (0.5 / jnp.pi) + 0.5
    u_s = jnp.where(jnp.isnan(u_s), 0.0, u_s)
    v_s = jnp.arccos(jnp.clip(ln[..., 2], -1.0, 1.0)) * (1.0 / jnp.pi)

    # ---- disk: uniform point ----------------------------------------------
    rt = jnp.sqrt(jnp.maximum(u2[..., 0], 0.0)) * r
    phi_d = u2[..., 1] * (2.0 * jnp.pi)
    lqx = rt * jnp.cos(phi_d)
    lqy = rt * jnp.sin(phi_d)
    fb = ana.frame_b[k]
    ft = ana.frame_t[k]
    nrm = ana.axis[k]
    q_d = pos + lqx[..., None] * fb + lqy[..., None] * ft
    dv_d = q_d - p
    r_sq_d = jnp.sum(dv_d * dv_d, -1)
    t_dsk = jnp.sqrt(jnp.maximum(r_sq_d, 1e-30))
    d_dsk = dv_d / t_dsk[..., None]
    cos_d = -jnp.sum(nrm * d_dsk, -1)
    front_d = jnp.sum(nrm * (p - pos), -1) >= 0.0
    cone_ok = -(-cos_d) >= ana.cos_apex[k]  # -d.n >= cosApex
    pdf_dsk = r_sq_d / jnp.maximum(cos_d * area, 1e-30)
    # uv: intersectionInfo at q (x along bitangent, y along tangent)
    u_d = jnp.arctan2(lqy, lqx) * (0.5 / jnp.pi) + 0.5
    u_d = jnp.where((lqx == 0.0) & (lqy == 0.0), 0.0, u_d)
    v_d = rt / jnp.maximum(r, 1e-30)

    # ---- cylinder: uniform position, area pdf ------------------------------
    hh = ana.half_h[k]
    cap_area = 2.0 * jnp.pi * r * r
    p_cap = jnp.where(ana.capped[k], cap_area / jnp.maximum(area, 1e-30), 0.0)
    take_cap = u1 < p_cap
    # reuse bits: cap pick rescales u1; sign from its upper half
    u1r = jnp.where(take_cap, u1 / jnp.maximum(p_cap, 1e-9), 0.0)
    sign = jnp.where(u1r < 0.5, -1.0, 1.0)
    # cap point: uniform disk via u2
    cx = rt * jnp.cos(phi_d)  # rt, phi_d reused from the disk branch
    cy = rt * jnp.sin(phi_d)
    pc_cap = jnp.stack([cx, sign * hh, cy], -1)
    n_cap = jnp.stack([jnp.zeros_like(hh), sign, jnp.zeros_like(hh)], -1)
    uv_cap = jnp.stack(
        [cx / jnp.maximum(r, 1e-30) * 0.5 + 0.5,
         cy / jnp.maximum(r, 1e-30) * 0.5 + 0.5], -1)
    # lateral: uniformCylinder(xi)
    phi_c = u2[..., 0] * (2.0 * jnp.pi)
    zc = u2[..., 1] * 2.0 - 1.0
    pc_lat = jnp.stack(
        [jnp.cos(phi_c) * r, zc * hh, jnp.sin(phi_c) * r], -1)
    n_lat = jnp.stack(
        [jnp.cos(phi_c), jnp.zeros_like(zc), jnp.sin(phi_c)], -1)
    uv_lat = jnp.stack([u2[..., 0], u2[..., 1]], -1)
    pc = jnp.where(take_cap[..., None], pc_cap, pc_lat)
    nc = jnp.where(take_cap[..., None], n_cap, n_lat)
    uv_c = jnp.where(take_cap[..., None], uv_cap, uv_lat)
    q_c = pos + jnp.einsum("nji,nj->ni", ir, pc)  # rot * p + pos
    ng_c = jnp.einsum("nji,nj->ni", ir, nc)
    dv_c = q_c - p
    r_sq_c = jnp.sum(dv_c * dv_c, -1)
    t_cyl = jnp.sqrt(jnp.maximum(r_sq_c, 1e-30))
    d_cyl = dv_c / t_cyl[..., None]
    cos_c = -jnp.sum(ng_c * d_cyl, -1)
    pdf_cyl = r_sq_c / jnp.maximum(cos_c * area, 1e-30)

    is_s = ptype == SPHERE
    is_d = ptype == DISK
    sel3 = lambda a, b, c: jnp.where(
        is_s[..., None], a, jnp.where(is_d[..., None], b, c))
    sel1 = lambda a, b, c: jnp.where(is_s, a, jnp.where(is_d, b, c))
    d = sel3(d_sph, d_dsk, d_cyl)
    dist = sel1(t_sph, t_dsk, t_cyl)
    pdf = sel1(pdf_sph, pdf_dsk, pdf_cyl)
    uv = sel3(
        jnp.stack([u_s, v_s], -1), jnp.stack([u_d, v_d], -1), uv_c)
    valid = sel1(outside, front_d & cone_ok & (cos_d > 0.0), cos_c > 0.0)
    return d, dist, pdf, uv, valid


def direct_pdf(ana: AnalyticTable, k, p, hit_p, d):
    """Primitive::directPdf for a bsdf-strategy ray from p hitting analytic
    prim k at hit_p along d. Sphere: spherical-cap pdf (Sphere.cpp:222-227);
    disk/cylinder: r^2/(|cos| * area) (Disk.cpp:225-232, via sampleDirect's
    area form for the cylinder)."""
    k = jnp.clip(k, 0, max(ana.n - 1, 0))
    ptype = ana.ptype[k]
    r = ana.radius[k]
    dist_c = jnp.sqrt(jnp.maximum(
        jnp.sum((ana.pos[k] - p) ** 2, -1), 1e-30))
    cos_max = jnp.sqrt(jnp.maximum(dist_c * dist_c - r * r, 0.0)) / dist_c
    pdf_sph = (0.5 / jnp.pi) / jnp.maximum(1.0 - cos_max, 1e-9)
    ng = normal_at(ana, k, hit_p)
    cos_t = jnp.abs(jnp.sum(ng * d, -1))
    r_sq = jnp.sum((hit_p - p) ** 2, -1)
    pdf_area = r_sq / jnp.maximum(cos_t * ana.area[k], 1e-30)
    return jnp.where(ptype == SPHERE, pdf_sph, pdf_area)


def sample_position(ana: AnalyticTable, k, u2, u1):
    """Primitive::samplePosition (emitter start for LT/BDPT/photons).
    Returns (p, ng, uv, pdf=1/area) — weight = pi*area*emission applied by
    the caller. Matches Sphere.cpp:146-160, Disk.cpp:151-164,
    Cylinder.cpp:152-173."""
    k = jnp.clip(k, 0, max(ana.n - 1, 0))
    ptype = ana.ptype[k]
    pos = ana.pos[k]
    r = ana.radius[k]
    ir = ana.inv_rot[k]
    hh = ana.half_h[k]

    # sphere: uniform sphere; uv = (xi.x + 0.5 wrap, acos(2 xi.y - 1)/pi)
    zs = u2[..., 1] * 2.0 - 1.0
    rs = jnp.sqrt(jnp.maximum(1.0 - zs * zs, 0.0))
    phi_s = u2[..., 0] * (2.0 * jnp.pi)
    ln_s = jnp.stack([jnp.cos(phi_s) * rs, jnp.sin(phi_s) * rs, zs], -1)
    ng_s = jnp.einsum("nji,nj->ni", ir, ln_s)
    p_s = pos + ng_s * r[..., None]
    u_s = jnp.where(u2[..., 0] + 0.5 > 1.0, u2[..., 0] - 0.5, u2[..., 0] + 0.5)
    v_s = jnp.arccos(jnp.clip(zs, -1.0, 1.0)) * (1.0 / jnp.pi)
    uv_s = jnp.stack([u_s, v_s], -1)

    # disk: uniform disk; uv = (xi.x + 0.5 wrap, sqrt(xi.y))
    rt = jnp.sqrt(jnp.maximum(u2[..., 1], 0.0)) * r
    phi_d = u2[..., 0] * (2.0 * jnp.pi)
    q_d = (pos + (rt * jnp.cos(phi_d))[..., None] * ana.frame_b[k]
           + (rt * jnp.sin(phi_d))[..., None] * ana.frame_t[k])
    u_d = jnp.where(u2[..., 0] + 0.5 > 1.0, u2[..., 0] - 0.5, u2[..., 0] + 0.5)
    uv_d = jnp.stack([u_d, jnp.sqrt(jnp.maximum(u2[..., 1], 0.0))], -1)

    # cylinder: caps by area share (prob 2 pi r^2 / area), else lateral
    cap_area = 2.0 * jnp.pi * r * r
    p_cap = jnp.where(ana.capped[k], cap_area / jnp.maximum(ana.area[k], 1e-30), 0.0)
    take_cap = u1 < p_cap
    u1r = jnp.where(take_cap, u1 / jnp.maximum(p_cap, 1e-9), 0.0)
    sign = jnp.where(u1r < 0.5, -1.0, 1.0)
    cx = rt * jnp.cos(phi_d)  # reuse the disk-branch uniform disk point
    cy = rt * jnp.sin(phi_d)
    pc_cap = jnp.stack([cx, sign * hh, cy], -1)
    n_cap = jnp.stack([jnp.zeros_like(hh), sign, jnp.zeros_like(hh)], -1)
    uv_cap = jnp.stack([cx / jnp.maximum(r, 1e-30) * 0.5 + 0.5,
                        cy / jnp.maximum(r, 1e-30) * 0.5 + 0.5], -1)
    phi_c = u2[..., 0] * (2.0 * jnp.pi)
    zc = u2[..., 1] * 2.0 - 1.0
    pc_lat = jnp.stack([jnp.cos(phi_c) * r, zc * hh, jnp.sin(phi_c) * r], -1)
    n_lat = jnp.stack([jnp.cos(phi_c), jnp.zeros_like(zc), jnp.sin(phi_c)], -1)
    uv_lat = u2
    pc = jnp.where(take_cap[..., None], pc_cap, pc_lat)
    nc = jnp.where(take_cap[..., None], n_cap, n_lat)
    uv_c = jnp.where(take_cap[..., None], uv_cap, uv_lat)
    p_c = pos + jnp.einsum("nji,nj->ni", ir, pc)
    ng_c = jnp.einsum("nji,nj->ni", ir, nc)

    is_s = ptype == SPHERE
    is_d = ptype == DISK
    sel3 = lambda a, b, c: jnp.where(
        is_s[..., None], a, jnp.where(is_d[..., None], b, c))
    p_out = sel3(p_s, q_d, p_c)
    ng = sel3(ng_s, jnp.broadcast_to(ana.axis[k], p_s.shape), ng_c)
    uv = sel3(uv_s, uv_d, uv_c)
    pdf = 1.0 / jnp.maximum(ana.area[k], 1e-30)
    return p_out, ng, uv, pdf


# ---------------------------------------------------------------------------
# host-side parameter extraction (flatten time)


def extract_params(ptype: str, m: np.ndarray, prim: dict):
    """prepareForRender parameter extraction from the 4x4 world transform."""
    m = np.asarray(m, np.float64)
    pos = m[:3, 3]
    scale = np.linalg.norm(m[:3, :3], axis=0)  # column norms = extractScale
    rot = m[:3, :3] / np.maximum(scale[None, :], 1e-30)
    if ptype == "sphere":
        radius = float(scale.max())
        return dict(
            ptype=SPHERE, pos=pos, radius=radius, inv_rot=rot.T,
            axis=np.array([0.0, 1.0, 0.0]), half_h=0.0, cos_apex=-2.0,
            capped=False, frame_t=np.zeros(3), frame_b=np.zeros(3),
            area=4.0 * np.pi * radius * radius,
        )
    if ptype == "disk":
        r = float(max(scale[0], scale[2]))
        n = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        n = n / max(np.linalg.norm(n), 1e-30)
        ca = float(prim.get("cone_angle", 90.0))
        cos_apex = float(np.cos(np.deg2rad(ca)))
        t, b = _tangent_frame(n)
        return dict(
            ptype=DISK, pos=pos, radius=r, inv_rot=rot.T, axis=n,
            half_h=0.0, cos_apex=cos_apex, capped=False,
            frame_t=t, frame_b=b, area=np.pi * r * r,
        )
    if ptype == "cylinder":
        radius = float(0.5 * max(scale[0], scale[2]))
        half_h = float(0.5 * scale[1])
        axis = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        capped = bool(prim.get("capped", True))
        area = 2.0 * np.pi * radius * 2.0 * half_h
        if capped:
            area += 2.0 * np.pi * radius * radius
        return dict(
            ptype=CYLINDER, pos=pos, radius=radius, inv_rot=rot.T,
            axis=axis, half_h=half_h, cos_apex=-2.0, capped=capped,
            frame_t=np.zeros(3), frame_b=np.zeros(3), area=area,
        )
    raise ValueError(ptype)


def _tangent_frame(n):
    """TangentFrame(n) (Mat/TangentFrame.hpp — Duff et al. branchless)."""
    s = np.copysign(1.0, n[2])
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    t = np.array([1.0 + s * n[0] * n[0] * a, s * b, -s * n[0]])
    bt = np.array([b, s + n[1] * n[1] * a, -n[1]])
    return t, bt


def build_table(entries) -> AnalyticTable | None:
    if not entries:
        return None
    g = lambda key, dt=np.float32: jnp.asarray(
        np.stack([np.asarray(e[key]) for e in entries]).astype(dt))
    return AnalyticTable(
        ptype=g("ptype", np.int32),
        pos=g("pos"),
        radius=g("radius"),
        inv_rot=g("inv_rot"),
        axis=g("axis"),
        half_h=g("half_h"),
        cos_apex=g("cos_apex"),
        capped=g("capped", bool),
        frame_t=g("frame_t"),
        frame_b=g("frame_b"),
        area=g("area"),
        n=len(entries),
    )
