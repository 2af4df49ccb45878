"""Device-side light sampling: area lights (triangle sets) + env light.

Semantics mirror the reference exactly:
 - area lights: area-weighted triangle pick + uniform barycentric point,
   one-sided, pdf = r^2 / (cos * totalArea)
   (TriangleMesh.cpp samplePosition/sampleDirect/directPdf; Quad.cpp:150-222);
 - infinite sphere: lat-long importance sampling of the emission bitmap with
   sin-theta-weighted, max-dilated weights; pdf = pdf_uv / (2 pi^2 sin theta)
   (InfiniteSphere.cpp:27-50,161-229).
All functions are batched over the wavefront.
"""
from __future__ import annotations

import jax.numpy as jnp
from ...utils.pytree import dataclass as pytree

from ...math import vecops as vo
from ...sampling import warps
from ...sampling.distributions import _searchsorted_strided
from ...models.textures import eval_texture

INV_TWO_PI_PI = 1.0 / (2.0 * jnp.pi * jnp.pi)
INF = jnp.float32(3.0e38)


@pytree
class LightSample:
    d: jnp.ndarray  # (N, 3) direction from shading point to light
    dist: jnp.ndarray  # (N,)
    pdf: jnp.ndarray  # (N,) solid-angle pdf
    radiance: jnp.ndarray  # (N, 3) emitted radiance toward the shading point
    valid: jnp.ndarray  # (N,) bool


def direction_to_uv(env, d):
    """World direction -> lat-long uv + sinTheta (InfiniteSphere.cpp:33-38)."""
    w = d @ env.inv_rot.T
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - w[..., 1] * w[..., 1], 0.0))
    u = jnp.arctan2(w[..., 2], w[..., 0]) * warps.INV_TWO_PI + 0.5
    v = jnp.arccos(jnp.clip(-w[..., 1], -1.0, 1.0)) * warps.INV_PI
    return jnp.stack([u, v], axis=-1), sin_theta


def uv_to_direction(env, uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * jnp.pi)
    theta = uv[..., 1] * jnp.pi
    sin_theta = jnp.sin(theta)
    local = jnp.stack(
        [jnp.cos(phi) * sin_theta, -jnp.cos(theta), jnp.sin(phi) * sin_theta], axis=-1
    )
    return local @ env.rot.T, sin_theta


def env_radiance(scene, d):
    """Escape-winner env emission (evalDirect of the LAST env primitive —
    it masks every earlier env for all directions)."""
    uv, _ = direction_to_uv(scene.env, d)
    may = (scene.env.tex_kind,) if scene.env.tex_kind >= 0 else None
    return eval_texture(
        scene.textures, jnp.broadcast_to(scene.env.tex, d.shape[:-1]), uv,
        may=may)


def _env_direct_pdf_one(scene, env, is_const, d):
    """Solid-angle pdf of one env's sampleDirect for direction d."""
    if is_const:
        return jnp.full(d.shape[:-1], warps.INV_FOUR_PI)
    h, w = env.dist.shape
    uv, sin_theta = direction_to_uv(env, d)
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip(((1.0 - uv[..., 1]) * h).astype(jnp.int32), 0, h - 1)
    pdf_uv = env.dist.prob(x, row) * (w * h)
    return jnp.where(
        sin_theta > 1e-6, pdf_uv * warps.INV_PI * warps.INV_TWO_PI / jnp.maximum(sin_theta, 1e-6), 0.0
    )


def env_direct_pdf(scene, d):
    """Solid-angle pdf of the escape-winner env's sampleDirect."""
    return _env_direct_pdf_one(scene, scene.env, scene.meta.env_is_constant, d)


def _sample_env_direct_one(scene, env, is_const, u2) -> LightSample:
    n = u2.shape[0]
    if is_const:
        d = warps.uniform_sphere(u2)
        uv, _ = direction_to_uv(env, d)
        rad = eval_texture(scene.textures, jnp.broadcast_to(env.tex, (n,)), uv,
                           may=(env.tex_kind,) if env.tex_kind >= 0 else None)
        return LightSample(
            d=d,
            dist=jnp.full((n,), INF),
            pdf=jnp.full((n,), warps.INV_FOUR_PI),
            radiance=rad,
            valid=jnp.ones((n,), bool),
        )
    h, w = env.dist.shape
    x, row, pdf_d, uvr = env.dist.sample(u2)
    # BitmapTexture::sample: u = (vx + x)/w, v = 1 - (vy + row)/h
    uv = jnp.stack([(uvr[..., 0] + x) / w, 1.0 - (uvr[..., 1] + row) / h], axis=-1)
    d, sin_theta = uv_to_direction(env, uv)
    pdf = pdf_d * (w * h) * warps.INV_PI * warps.INV_TWO_PI / jnp.maximum(sin_theta, 1e-6)
    rad = eval_texture(scene.textures, jnp.broadcast_to(env.tex, (n,)), uv,
                       may=(env.tex_kind,) if env.tex_kind >= 0 else None)
    return LightSample(
        d=d,
        dist=jnp.full((n,), INF),
        pdf=pdf,
        radiance=rad,
        valid=(sin_theta > 1e-6) & (pdf > 0.0),
    )


def _merge_ls(sel, a: LightSample, b: LightSample) -> LightSample:
    return LightSample(
        d=vo.where3(sel, a.d, b.d),
        dist=jnp.where(sel, a.dist, b.dist),
        pdf=jnp.where(sel, a.pdf, b.pdf),
        radiance=vo.where3(sel, a.radiance, b.radiance),
        valid=jnp.where(sel, a.valid, b.valid),
    )


def sample_env_direct(scene, li, u2) -> LightSample:
    """sampleDirect of the env light chosen at light index li (N,): each env
    primitive is its own light row; the slot picks its EnvLight entry."""
    meta = scene.meta
    envs = scene.envs if meta.n_envs else (scene.env,)
    consts = meta.env_const if meta.n_envs else (meta.env_is_constant,)
    ls = _sample_env_direct_one(scene, envs[0], consts[0], u2)
    if len(envs) > 1:
        slot = scene.lights.env_slot[li]
        for e in range(1, len(envs)):
            ls_e = _sample_env_direct_one(scene, envs[e], consts[e], u2)
            ls = _merge_ls(slot == e, ls_e, ls)
    return ls


def cap_in_cone_k(scene, d, k: int):
    """Rays inside cap k's emission cone (InfiniteSphereCap.cpp:60-64)."""
    cap = scene.cap
    return vo.dot(d, jnp.broadcast_to(cap.dir[k], d.shape)) >= cap.cos_angle[k]


def cap_direct_pdf_k(scene, d, k: int):
    """Uniform spherical-cap solid-angle pdf of cap k
    (SampleWarp::uniformSphericalCapPdf)."""
    pdf = warps.INV_TWO_PI / jnp.maximum(1.0 - scene.cap.cos_angle[k], 1e-9)
    return jnp.where(cap_in_cone_k(scene, d, k), pdf, 0.0)


def sample_cap_direct(scene, li, u2) -> LightSample:
    """sampleDirect of the cap light chosen at light index li (N,)
    (InfiniteSphereCap.cpp:131-140): uniform direction in the cone around
    its axis, dist = inf. Lanes whose li is not a cap return garbage
    (callers gate on lights.cap_slot[li] >= 0)."""
    cap = scene.cap
    n = u2.shape[0]
    slot = jnp.maximum(scene.lights.cap_slot[li], 0)
    cdir = cap.dir[slot]  # (N, 3)
    ccos = cap.cos_angle[slot]  # (N,)
    cos_t = ccos + u2[..., 0] * (1.0 - ccos)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = u2[..., 1] * (2.0 * jnp.pi)
    local = jnp.stack([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1)
    t, b = vo.tangent_frame(cdir)
    d = vo.to_global(t, b, cdir, local)
    pdf = warps.INV_TWO_PI / jnp.maximum(1.0 - ccos, 1e-9)
    return LightSample(
        d=d,
        dist=jnp.full((n,), INF),
        pdf=pdf,
        radiance=cap.radiance[slot],
        valid=jnp.ones((n,), bool),
    )


def infinite_radiance(scene, d):
    """Emission seen by an escaped ray: every infinite primitive is tested and
    the LAST one in scene order that intersects wins (TraceableScene.hpp:194-209
    overwrites `data` in list order); a cap only intersects inside its cone.
    meta.esc_caps holds exactly the caps listed after the last env, in
    ascending primitive order, so iterating with overwrite reproduces it."""
    meta = scene.meta
    rad = env_radiance(scene, d) if meta.has_env else jnp.zeros(d.shape[:-1] + (3,))
    for k in meta.esc_caps:
        rad = jnp.where(cap_in_cone_k(scene, d, k)[..., None],
                        jnp.broadcast_to(scene.cap.radiance[k], rad.shape), rad)
    return rad


def infinite_needs_escape_add(scene, d, was_specular):
    """Lanes whose escape emission is NOT covered by the NEE/MIS machinery:
    light sampling off, a specular prior bounce, or the winning infinite
    primitive is not samplable (cf. handleInfiniteLights gating)."""
    meta = scene.meta
    if not meta.enable_light_sampling:
        return jnp.ones(d.shape[:-1], bool)
    env_unsampled = meta.has_env and meta.env_light_index < 0
    winner_unsampled = jnp.full(d.shape[:-1], env_unsampled)
    for k in meta.esc_caps:
        cap_unsampled = _cap_li(meta, k) < 0
        winner_unsampled = jnp.where(
            cap_in_cone_k(scene, d, k), cap_unsampled, winner_unsampled
        )
    return was_specular | winner_unsampled


def _cap_li(meta, k: int) -> int:
    """Light index of cap slot k (-1 when unsamplable)."""
    return meta.cap_light_idx[k] if k < len(meta.cap_light_idx) else -1


def any_infinite_sampled(meta) -> bool:
    """True when some escape-winning infinite light has a light row (so the
    bsdf strategy can match it and needs the winner radiance/pdf)."""
    return any(i >= 0 for i in meta.env_light_idx) or any(
        _cap_li(meta, k) >= 0 for k in meta.esc_caps)


def infinite_winner_pdf(scene, d):
    """Solid-angle direct-sampling pdf of the WINNING infinite light for an
    escape direction d (last-listed infinite primitive wins, TraceableScene
    intersectInfinites order); 0 where the winner is unsamplable — which
    makes power_heuristic(pdf_bsdf, 0) = 1, the handleInfiniteLights gate."""
    meta = scene.meta
    pdf = jnp.zeros(d.shape[:-1])
    if meta.has_env and meta.env_light_index >= 0:
        pdf = env_direct_pdf(scene, d)
    for k in meta.esc_caps:
        cap_pdf = (
            cap_direct_pdf_k(scene, d, k)
            if _cap_li(meta, k) >= 0
            else jnp.zeros(d.shape[:-1])
        )
        pdf = jnp.where(cap_in_cone_k(scene, d, k), cap_pdf, pdf)
    return pdf


def escape_winner(scene, d, want_radiance=True):
    """(winner light index, radiance, direct pdf) of the infinite primitive
    an escaping ray 'hits' — the LAST listed infinite that intersects d
    (TraceableScene.hpp:194-209). The light index is -2 where nothing
    intersects or the winner is unsamplable, so `li == wl` is the exact
    bsdf-strategy match test of estimateDirect (the intersected primitive
    must BE the chosen light)."""
    meta = scene.meta
    shp = d.shape[:-1]
    wl = jnp.full(shp, jnp.int32(-2))
    e = jnp.zeros(shp + (3,))
    pdf = jnp.zeros(shp)
    if meta.has_env:
        wl = jnp.full(
            shp,
            jnp.int32(meta.env_light_index if meta.env_light_index >= 0 else -2),
        )
        if want_radiance:
            e = env_radiance(scene, d)
        if meta.env_light_index >= 0:
            pdf = env_direct_pdf(scene, d)
    for k in meta.esc_caps:
        ic = cap_in_cone_k(scene, d, k)
        li_k = _cap_li(meta, k)
        wl = jnp.where(ic, jnp.int32(li_k if li_k >= 0 else -2), wl)
        e = jnp.where(ic[..., None],
                      jnp.broadcast_to(scene.cap.radiance[k], e.shape), e)
        pdf = jnp.where(
            ic, cap_direct_pdf_k(scene, d, k) if li_k >= 0 else 0.0, pdf)
    return wl, e, pdf


def chosen_infinite_eval(scene, li, d):
    """bsdf/phase-strategy target eval for CHOSEN infinite lights: the
    reference's estimateDirect bsdf strategy intersects the chosen light
    primitive ITSELF (TraceBase.cpp:286-319, attenuatedEmission ->
    light.intersect), so a chosen env that is masked at escape time (a
    later-listed env/cap overwrites it in intersectInfinites) still
    contributes its own radiance and directPdf whenever the bsdf ray
    escapes the real scene geometry. Returns (match, radiance, pdf) where
    match is True for lanes whose chosen light li is a samplable infinite
    primitive the ray intersects (env: every direction; cap: inside its
    cone); False for area/point choices."""
    meta = scene.meta
    shp = d.shape[:-1]
    match = jnp.zeros(shp, bool)
    e = jnp.zeros(shp + (3,))
    pdf = jnp.zeros(shp)
    envs = scene.envs if meta.n_envs else ((scene.env,) if meta.has_env else ())
    consts = (meta.env_const if meta.n_envs
              else ((meta.env_is_constant,) if meta.has_env else ()))
    for s in range(len(envs)):
        li_e = meta.env_light_idx[s] if s < len(meta.env_light_idx) else -1
        if li_e < 0:
            continue
        sel = li == li_e
        uv, _ = direction_to_uv(envs[s], d)
        rad = eval_texture(scene.textures,
                           jnp.broadcast_to(envs[s].tex, shp), uv)
        e = jnp.where(sel[..., None], rad, e)
        pdf = jnp.where(
            sel, _env_direct_pdf_one(scene, envs[s], consts[s], d), pdf)
        match = match | sel
    for k in range(len(meta.cap_light_idx)):
        li_c = meta.cap_light_idx[k]
        if li_c < 0:
            continue
        sel = (li == li_c) & cap_in_cone_k(scene, d, k)
        e = jnp.where(sel[..., None],
                      jnp.broadcast_to(scene.cap.radiance[k], e.shape), e)
        pdf = jnp.where(sel, cap_direct_pdf_k(scene, d, k), pdf)
        match = match | sel
    return match, e, pdf


def _quad_solid_angle(p, base, e0, e1):
    """Solid angle of the (base, e0, e1) parallelogram seen from p via the
    spherical-excess formula (Quad.cpp:256-281 / Disk.cpp:268-295 inner Q)."""
    R0 = base - p
    R1 = R0 + e0
    R2 = R1 + e1
    R3 = R0 + e1
    def nrm(a, b):
        c = jnp.cross(a, b)
        return c / jnp.sqrt(jnp.maximum(vo.length_sq(c), 1e-30))[..., None]
    n0, n1, n2, n3 = nrm(R0, R1), nrm(R1, R2), nrm(R2, R3), nrm(R3, R0)
    acos = lambda a, b: jnp.arccos(jnp.clip(vo.dot(a, b), -1.0, 1.0))
    Q = acos(n0, n1) + acos(n1, n2) + acos(n2, n3) + acos(n3, n0)
    return 2.0 * jnp.pi - jnp.abs(Q)


def _light_weights(scene, p):
    """Per-light approximateRadiance at p (TraceBase.cpp:416-459): rows of
    (L, N); 'none' lights get the reference's uniform replacement (the mean
    of the known weights). Returns (w, total)."""
    lights = scene.lights
    n = p.shape[0]
    rows = []
    for i, kind in enumerate(lights.apx_kind):
        avg = lights.apx_avg[i]
        if kind == "const":
            rows.append(jnp.full((n,), avg))
        elif kind == "point":
            r_sq = vo.length_sq(lights.apx_base[i] - p)
            rows.append(avg / jnp.maximum(r_sq, 1e-30))
        elif kind == "sphere":
            Lv = lights.apx_base[i] - p
            d = jnp.sqrt(jnp.maximum(vo.length_sq(Lv), 1e-30))
            r = lights.apx_e0[i][0]
            cos_t = jnp.sqrt(jnp.maximum(d * d - r * r, 0.0)) / d
            rows.append(2.0 * jnp.pi * (1.0 - cos_t) * avg)
        elif kind == "quad":
            R0 = lights.apx_base[i] - p
            behind = vo.dot(R0, jnp.broadcast_to(lights.apx_n[i], p.shape)) >= 0.0
            sa = _quad_solid_angle(p, lights.apx_base[i], lights.apx_e0[i],
                                   lights.apx_e1[i])
            rows.append(jnp.where(behind, 0.0, sa * avg))
        elif kind == "disk":
            cone_d = p - lights.apx_cbase[i]
            dl = jnp.sqrt(jnp.maximum(vo.length_sq(cone_d), 1e-30))
            gate = vo.dot(cone_d, jnp.broadcast_to(lights.apx_n[i], p.shape)) / dl
            base = (lights.apx_base[i] - lights.apx_e0[i] - lights.apx_e1[i])
            sa = _quad_solid_angle(p, base, 2.0 * lights.apx_e0[i],
                                   2.0 * lights.apx_e1[i])
            rows.append(jnp.where(gate < scene.lights.cone_cos[i], 0.0, sa * avg))
        else:  # "none" -> -1 (unknown; TriangleMesh/Cube/Curves/Cylinder)
            rows.append(jnp.full((n,), -1.0))
    w = jnp.stack(rows, 0)  # (L, N)
    known = w >= 0.0
    total_k = jnp.sum(jnp.where(known, w, 0.0), 0)
    n_k = jnp.sum(known, 0)
    uniform_w = jnp.where(total_k == 0.0, 1.0, total_k) / jnp.maximum(n_k, 1)
    uniform_w = jnp.where(n_k == 0, 1.0, uniform_w)
    w = jnp.where(known, w, uniform_w[None])
    return w, jnp.sum(w, 0)


def choose_light(scene, u, p):
    """TraceBase::chooseLight: pick a light by approximate received
    radiance; returns (li (N,), weight = total/pdf_i (N,)). weight = 0 when
    total = 0 (no reachable light -> contribution cancels)."""
    meta = scene.meta
    nl = meta.n_lights
    if nl <= 1 or all(k == "none" for k in scene.lights.apx_kind):
        li = jnp.minimum((u * nl).astype(jnp.int32), nl - 1)
        return li, jnp.full(p.shape[:-1], jnp.float32(nl))
    w, total = _light_weights(scene, p)
    cum = jnp.cumsum(w, 0)
    li = jnp.sum((u * total)[None] >= cum, 0).astype(jnp.int32)
    li = jnp.clip(li, 0, nl - 1)
    wi = jnp.take_along_axis(w, li[None], 0)[0]
    return li, jnp.where(total > 0.0, total / jnp.maximum(wi, 1e-30), 0.0)


def light_choice_pdf(scene, li, p):
    """Probability chooseLight(p) picks light li — the factor folded into
    MIS light pdfs by integrators that pair NEE with the continuation ray."""
    meta = scene.meta
    nl = meta.n_lights
    if nl <= 1 or all(k == "none" for k in scene.lights.apx_kind):
        return jnp.full(p.shape[:-1], 1.0 / max(nl, 1))
    w, total = _light_weights(scene, p)
    wi = jnp.take_along_axis(w, jnp.clip(li, 0, nl - 1)[None], 0)[0]
    return jnp.where(total > 0.0, wi / jnp.maximum(total, 1e-30), 0.0)


def infinite_winner_choice_pdf(scene, d, p):
    """chooseLight(p) probability of the WINNING infinite light for escape
    direction d (pairs with infinite_winner_pdf for MIS)."""
    meta = scene.meta
    wid = jnp.full(d.shape[:-1], max(meta.env_light_index, 0), jnp.int32)
    for k in meta.esc_caps:
        wid = jnp.where(cap_in_cone_k(scene, d, k), max(_cap_li(meta, k), 0), wid)
    return light_choice_pdf(scene, wid, p)


def sample_area_direct(scene, li, p, u_tri, u2) -> LightSample:
    """Sample a point on area light li (N,) as seen from p (N, 3).
    Analytic lights (sphere/disk/cylinder) dispatch to their exact direct
    samplers (spherical cap / uniform disk / uniform position) — see
    models/primitives/analytic.py."""
    if scene.lights.has_surface:
        ls = _sample_area_direct_tris(scene, li, p, u_tri, u2)
    else:
        # no surface lights: callers always overwrite via the env/cap/point
        # merges below — skip the CDF walk and triangle gathers statically
        n = u_tri.shape[0]
        z3 = jnp.zeros((n, 3))
        ls = LightSample(d=z3, dist=jnp.zeros((n,)), pdf=jnp.ones((n,)),
                         radiance=z3, valid=jnp.zeros((n,), bool))
    if scene.meta.has_analytic:
        from . import analytic as ana_mod

        k = scene.lights.ana_prim[li]
        d_a, dist_a, pdf_a, uv_a, valid_a = ana_mod.sample_direct(
            scene.ana, k, p, u2, u_tri)
        rad_a = eval_texture(scene.textures, scene.lights.tex[li], uv_a)
        is_a = k >= 0
        ls = LightSample(
            d=vo.where3(is_a, d_a, ls.d),
            dist=jnp.where(is_a, dist_a, ls.dist),
            pdf=jnp.where(is_a, pdf_a, ls.pdf),
            radiance=vo.where3(is_a, rad_a, ls.radiance),
            valid=jnp.where(is_a, valid_a, ls.valid),
        )
    return ls


def _sample_area_direct_tris(scene, li, p, u_tri, u2) -> LightSample:
    lights = scene.lights
    count = lights.count[li]
    cdf_off = lights.cdf_offset[li]
    off = lights.offset[li]
    area = lights.area[li]

    k = _searchsorted_strided(
        lights.cdf, cdf_off, u_tri, count + 1, max_len=lights.max_count + 1
    ) - 1
    k = jnp.clip(k, 0, jnp.maximum(count - 1, 0))
    tri = lights.tri_idx[jnp.clip(off + k, 0, lights.tri_idx.shape[0] - 1)]

    lam = warps.uniform_triangle_uv(u2)  # barycentric weights for (p0, p1)
    lx = lam[..., 0:1]
    ly = lam[..., 1:2]
    v0 = scene.tris.v0[tri]
    e1 = scene.tris.e1[tri]
    e2 = scene.tris.e2[tri]
    # reference: p = p0*l.x + p1*l.y + p2*(1-lx-ly)
    q = v0 + e1 * ly + e2 * (1.0 - lx - ly)
    ng = scene.tri_ng[tri]
    uv = (
        scene.tri_uv0[tri] * lx
        + scene.tri_uv1[tri] * ly
        + scene.tri_uv2[tri] * (1.0 - lx - ly)
    )

    dvec = q - p
    r_sq = vo.length_sq(dvec)
    dist = jnp.sqrt(jnp.maximum(r_sq, 1e-30))
    d = dvec / dist[..., None]
    cos_theta = -vo.dot(ng, d)
    # emission-cone gating (Disk.cpp:188: reject when -d.n < cos(cone_angle));
    # cone_cos is 0 for ordinary lights, reducing to the plain front test
    valid = cos_theta > jnp.maximum(lights.cone_cos[li], 0.0)
    valid = valid & (cos_theta > 0.0)
    pdf = r_sq / jnp.maximum(cos_theta * area, 1e-30)
    rad = eval_texture(scene.textures, lights.tex[li], uv,
                       may=lights.emit_kinds)
    return LightSample(d=d, dist=dist, pdf=pdf, radiance=rad, valid=valid)


def area_direct_pdf(scene, tri, p, hit_p, d):
    """directPdf of the area light owning prim `tri` (a triangle id or an
    analytic virtual id >= T), for a hit at hit_p reached from p along d
    (TriangleMesh::directPdf; Sphere.cpp:222-227 spherical-cap pdf)."""
    li = scene.tri_light[tri]
    area = scene.lights.area[jnp.maximum(li, 0)]
    ng = scene.tri_ng[tri]
    cos_theta = jnp.abs(vo.dot(d, ng))
    r_sq = vo.length_sq(hit_p - p)
    pdf = r_sq / jnp.maximum(cos_theta * area, 1e-30)
    if scene.meta.has_analytic:
        from . import analytic as ana_mod

        n_tris = scene.tris.v0.shape[0]
        is_a = tri >= n_tris
        pdf_a = ana_mod.direct_pdf(scene.ana, tri - n_tris, p, hit_p, d)
        pdf = jnp.where(is_a, pdf_a, pdf)
    return jnp.where(li >= 0, pdf, 0.0)


def sample_point_direct(scene, li, p) -> LightSample:
    """Point::sampleDirect (Point.cpp:98-106) for the point light at light
    index li (N,): d to the point, pdf = r^2 in the reference's convention
    (weight = emission/pdf with emission = power/(4 pi)); we fold it so
    radiance/pdf gives power/(4 pi r^2), and the dirac light takes MIS
    weight 1 (no bsdf strategy can hit it). Lanes whose li is not a point
    light return garbage (callers gate on lights.pt_slot[li] >= 0)."""
    pt = scene.point
    slot = jnp.maximum(scene.lights.pt_slot[li], 0)
    dvec = pt.pos[slot] - p
    r_sq = vo.length_sq(dvec)
    dist = jnp.sqrt(jnp.maximum(r_sq, 1e-30))
    d = dvec / dist[..., None]
    return LightSample(
        d=d,
        dist=dist,
        pdf=r_sq,
        radiance=pt.intensity[slot],
        valid=jnp.ones(p.shape[:-1], bool),
    )


@pytree
class EmitterSample:
    p: jnp.ndarray  # (N, 3) position on the light
    ng: jnp.ndarray  # (N, 3)
    uv: jnp.ndarray  # (N, 2)
    weight: jnp.ndarray  # (N, 3) position weight = pi * area * emission
    radiance: jnp.ndarray  # (N, 3) emitted radiance
    valid: jnp.ndarray
    tri: jnp.ndarray = None  # (N,) sampled triangle (medium lookup)


def sample_emitter_position(scene, li, u_tri, u2) -> EmitterSample:
    """Primitive::samplePosition for area lights (TriangleMesh.cpp / Quad.cpp:
    area-weighted triangle + uniform barycentric; weight = pi*area*emission).
    Analytic lights use their exact samplePosition (uniform sphere / disk /
    cylinder surface) and report tri = virtual id T+k."""
    es = _sample_emitter_position_tris(scene, li, u_tri, u2)
    if scene.meta.has_analytic:
        from . import analytic as ana_mod

        lights = scene.lights
        k = lights.ana_prim[li]
        p_a, ng_a, uv_a, _ = ana_mod.sample_position(scene.ana, k, u2, u_tri)
        rad_a = eval_texture(scene.textures, lights.tex[li], uv_a)
        is_a = k >= 0
        n_tris = scene.tris.v0.shape[0]
        es = EmitterSample(
            p=vo.where3(is_a, p_a, es.p),
            ng=vo.where3(is_a, ng_a, es.ng),
            uv=jnp.where(is_a[..., None], uv_a, es.uv),
            weight=vo.where3(
                is_a, (jnp.pi * lights.area[li])[..., None] * rad_a, es.weight),
            radiance=vo.where3(is_a, rad_a, es.radiance),
            valid=jnp.where(is_a, True, es.valid),
            tri=jnp.where(is_a, n_tris + jnp.maximum(k, 0), es.tri),
        )
    return es


def _sample_emitter_position_tris(scene, li, u_tri, u2) -> EmitterSample:
    lights = scene.lights
    count = lights.count[li]
    cdf_off = lights.cdf_offset[li]
    off = lights.offset[li]
    area = lights.area[li]

    k = _searchsorted_strided(
        lights.cdf, cdf_off, u_tri, count + 1, max_len=lights.max_count + 1
    ) - 1
    k = jnp.clip(k, 0, jnp.maximum(count - 1, 0))
    tri = lights.tri_idx[jnp.clip(off + k, 0, lights.tri_idx.shape[0] - 1)]

    lam = warps.uniform_triangle_uv(u2)
    lx = lam[..., 0:1]
    ly = lam[..., 1:2]
    v0 = scene.tris.v0[tri]
    e1 = scene.tris.e1[tri]
    e2 = scene.tris.e2[tri]
    q = v0 + e1 * ly + e2 * (1.0 - lx - ly)
    ng = scene.tri_ng[tri]
    uv = (
        scene.tri_uv0[tri] * lx
        + scene.tri_uv1[tri] * ly
        + scene.tri_uv2[tri] * (1.0 - lx - ly)
    )
    rad = eval_texture(scene.textures, lights.tex[li], uv)
    is_area = ~lights.is_env[li]
    return EmitterSample(
        p=q,
        ng=ng,
        uv=uv,
        weight=(jnp.pi * area)[..., None] * rad,
        radiance=rad,
        valid=is_area & (count > 0),
        tri=tri,
    )
