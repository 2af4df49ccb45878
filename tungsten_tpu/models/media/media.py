"""Participating media: homogeneous medium with pluggable generalized
transmittance and phase function (src/core/media/HomogeneousMedium.cpp:66-110,
Medium.hpp:22-76).

Per-lane medium id (-1 = vacuum) indexes the SoA medium table. The reference's
MediumState{firstScatter, bounce} threads through the wavefront as two lane
arrays (needed by the non-exponential 4-case transmittance).

Distance sampling matches the reference exactly: spectral channel selection
via nextDiscrete(3), free-flight tau from the transmittance model scaled by
the chosen channel's sigma_t, MIS-style spectral pdf averaging, and separate
surface/medium pdf cases.
"""
from __future__ import annotations

from typing import List

import numpy as np
import jax.numpy as jnp
from ...utils.pytree import dataclass as pytree, field

from ..grids import (
    DenseGrid,
    grid_density,
    grid_emission,
    grid_inverse_optical_depth,
    grid_optical_depth,
    load_grid_spec,
)
from ..phase import phase_id
from ..transmittance import (
    trans_eval,
    trans_id,
    trans_medium_pdf,
    trans_sample,
    trans_sigma_bar,
    _sigma_bar_full,
    trans_surface_prob,
)

INF = jnp.float32(3.0e38)


@pytree
class MediumTable:
    sigma_a: jnp.ndarray  # (K, 3)
    sigma_s: jnp.ndarray  # (K, 3)
    sigma_t: jnp.ndarray  # (K, 3)
    absorption_only: jnp.ndarray  # (K,) bool
    phase_type: jnp.ndarray  # (K,) int32
    phase_g: jnp.ndarray  # (K,)
    trans_type: jnp.ndarray  # (K,) int32
    trans_params: jnp.ndarray  # (K, 8) [a, b, pulses] / interpolated layout
    max_bounce: jnp.ndarray  # (K,) int32
    exp_dir: jnp.ndarray = None  # (K, 3) falloff_scale * unit falloff dir
    exp_x0: jnp.ndarray = None  # (K,) exp_dir . unit_point
    hetero_kind: jnp.ndarray = None  # (K,) 0=uniform 1=exp 2=atmosphere 3=voxel
    atm_center: jnp.ndarray = None  # (K, 3)
    atm_s: jnp.ndarray = None  # (K,) effective falloff scale (falloff/radius)
    atm_r2: jnp.ndarray = None  # (K,) radius^2
    vox_grids: tuple = ()  # tuple[DenseGrid] (pytree leaves)

    n_media: int = field(pytree_node=False, default=0)
    trans_present: tuple = field(pytree_node=False, default=())
    has_hetero: bool = field(pytree_node=False, default=False)
    vox_owner: tuple = field(pytree_node=False, default=())  # grid -> medium id
    has_emissive_grid: bool = field(pytree_node=False, default=False)


def pack_media(specs: List[dict], resolve=None, prim_origin=None) -> MediumTable:
    k = max(len(specs), 1)
    sa = np.zeros((k, 3), np.float32)
    ss = np.zeros((k, 3), np.float32)
    pt = np.zeros(k, np.int32)
    pg = np.zeros(k, np.float32)
    tt = np.zeros(k, np.int32)
    tp = np.ones((k, 8), np.float32)
    mb = np.full(k, 1024, np.int32)
    ed = np.zeros((k, 3), np.float32)
    ex = np.zeros(k, np.float32)
    hk = np.zeros(k, np.int32)
    ac = np.zeros((k, 3), np.float32)
    asc = np.ones(k, np.float32)
    ar2 = np.ones(k, np.float32)
    vox_grids = []
    vox_owner = []
    for i, spec in enumerate(specs):
        mtype = spec.get("type", "homogeneous")
        if mtype == "exponential":
            # ExponentialMedium.cpp: density(p) = exp(-scale*(p-unit).dot(dir))
            fdir = np.asarray(spec.get("falloff_direction", [0.0, 1.0, 0.0]), np.float64)
            fdir = fdir / max(np.linalg.norm(fdir), 1e-30)
            fs = float(spec.get("falloff_scale", 1.0))
            up = np.asarray(spec.get("unit_point", [0.0, 0.0, 0.0]), np.float64)
            if np.ndim(up) == 0:
                up = np.repeat(up, 3)
            ed[i] = (fs * fdir).astype(np.float32)
            ex[i] = float(np.dot(fs * fdir, up))
            hk[i] = 1
        elif mtype == "atmosphere":
            # AtmosphericMedium.cpp: density(p) = exp(-s^2 (|p-c|^2 - R^2)),
            # s = falloff_scale / radius; a "pivot" names a primitive whose
            # transform origin becomes the center
            # (AtmosphericMedium.cpp:63-70 prepareForRender)
            center = spec.get("center", [0.0, 0.0, 0.0])
            if "pivot" in spec:
                c = prim_origin(spec["pivot"]) if prim_origin else None
                if c is not None:
                    center = c
            r = float(spec.get("radius", 1.0))
            ac[i] = np.asarray(center, np.float32)
            asc[i] = float(spec.get("falloff_scale", 1.0)) / max(r, 1e-30)
            ar2[i] = r * r
            hk[i] = 2
        elif mtype == "voxel":
            # VoxelMedium.cpp:97-186: sigma_t scaled by the grid density;
            # distance sampling through Grid::inverseOpticalDepth
            gspec = spec.get("grid", {})
            vox_grids.append(load_grid_spec(gspec, resolve=resolve))
            vox_owner.append(i)
            hk[i] = 3
        elif mtype != "homogeneous":
            raise NotImplementedError(f"medium type '{mtype}' not implemented yet")
        density = spec.get("density", 1.0)

        def vec3(v, default=0.0):
            a = np.asarray(spec.get(v, default), np.float32).ravel()
            return np.repeat(a, 3) if a.size == 1 else a

        sa[i] = vec3("sigma_a") * density
        ss[i] = vec3("sigma_s") * density
        ph = spec.get("phase_function", {"type": "isotropic"})
        if isinstance(ph, str):
            ph = {"type": ph}
        pt[i] = phase_id(ph.get("type", "isotropic"))
        pg[i] = ph.get("g", 0.0)
        tr = spec.get("transmittance", {"type": "exponential"})
        if isinstance(tr, str):
            tr = {"type": tr}
        tt[i] = trans_id(tr.get("type", "exponential"))

        def base_params(trd):
            if trd.get("type") == "pulse":
                return [trd.get("min", 0.0), trd.get("max", 1.0),
                        trd.get("num_pulses", 4)]
            if trd.get("type") == "davis_weinstein":
                return [float(np.clip(trd.get("h", 0.75), 0.5, 1.0)),
                        trd.get("c", 1.0), 4.0]
            return [
                trd.get("sigma_a", trd.get("max_t", trd.get("rate", trd.get("alpha", 1.0)))),
                trd.get("sigma_b", 1.0), 4.0,
            ]

        if tr.get("type") == "interpolated":
            # [u, typeA, typeB, paA, pbA, paB, pbB, -]; defaults mirror
            # InterpolatedTransmittance(): linear + erlang, ratio 0.5
            tra = tr.get("tr_a", {"type": "linear"})
            trb = tr.get("tr_b", {"type": "erlang"})
            if isinstance(tra, str):
                tra = {"type": tra}
            if isinstance(trb, str):
                trb = {"type": trb}
            if tra.get("type") in ("pulse", "interpolated") or trb.get("type") in (
                "pulse", "interpolated"
            ):
                raise NotImplementedError(
                    "interpolated transmittance children limited to 2-param models"
                )
            tp[i, 0] = tr.get("ratio", 0.5)
            tp[i, 1] = trans_id(tra.get("type", "linear"))
            tp[i, 2] = trans_id(trb.get("type", "erlang"))
            tp[i, 3:5] = base_params(tra)[:2]
            tp[i, 5:7] = base_params(trb)[:2]
        else:
            tp[i, 0:3] = base_params(tr)
        mb[i] = spec.get("max_bounces", 1024)
    return MediumTable(
        sigma_a=jnp.asarray(sa),
        sigma_s=jnp.asarray(ss),
        sigma_t=jnp.asarray(sa + ss),
        absorption_only=jnp.asarray((ss == 0).all(axis=1)),
        phase_type=jnp.asarray(pt),
        phase_g=jnp.asarray(pg),
        trans_type=jnp.asarray(tt),
        trans_params=jnp.asarray(tp),
        max_bounce=jnp.asarray(mb),
        n_media=len(specs),
        trans_present=tuple(sorted(set(int(x) for x in tt))),
        exp_dir=jnp.asarray(ed),
        exp_x0=jnp.asarray(ex),
        hetero_kind=jnp.asarray(hk),
        atm_center=jnp.asarray(ac),
        atm_s=jnp.asarray(asc),
        atm_r2=jnp.asarray(ar2),
        vox_grids=tuple(vox_grids),
        vox_owner=tuple(vox_owner),
        has_hetero=bool((hk != 0).any()),
        has_emissive_grid=any(g.has_emission for g in vox_grids),
    )


def _ray_falloff(media, i, o, d):
    """Per-lane optical-depth line parameters: density(t) = exp(-(x + dx t))
    (ExponentialMedium.cpp:58-66). Zero for homogeneous media."""
    fdir = media.exp_dir[i]
    x = jnp.sum(o * fdir, axis=-1) - media.exp_x0[i]
    dx = jnp.sum(d * fdir, axis=-1)
    return x, dx


def _dens_integral(x, dx, t):
    """int_0^t density ds (ExponentialMedium::densityIntegral); reduces to t
    when x = dx = 0."""
    small = jnp.abs(dx) < 1e-12
    safe_dx = jnp.where(small, 1.0, dx)
    inf = t >= 1e30
    fin = jnp.where(
        small,
        jnp.exp(-x) * t,
        (jnp.exp(-x) - jnp.exp(-dx * t - x)) / safe_dx,
    )
    return jnp.where(inf, jnp.exp(-x) / safe_dx, fin)


def _inverse_optical_depth(x, dx, tau):
    """ExponentialMedium::inverseOpticalDepth; identity (tau) when x = dx = 0."""
    small = jnp.abs(dx) < 1e-12
    safe_dx = jnp.where(small, 1.0, dx)
    denom = 1.0 - dx * jnp.exp(x) * tau
    t_gen = jnp.where(
        denom <= 0.0, INF, -jnp.log(jnp.maximum(denom, 1e-38)) / safe_dx
    )
    return jnp.where(small, tau * jnp.exp(x), t_gen)


def _hetero_ray(media, i, o, d):
    """Per-lane heterogeneous-profile line parameters for the analytic
    density models. kind 1 (exponential): density(t)=exp(-(x+dx t)); kind 2
    (atmosphere, AtmosphericMedium.cpp:94-124): work in the shifted
    coordinate u = t + t0 (t0 = along-ray offset of the closest approach),
    density(u) = exp(-(eh + s^2 u^2)) with eh = s^2 (h^2 - R^2); kind 3
    (voxel, VoxelMedium.cpp:97-186): raymarched dense grid — the ray itself
    rides in hp for the march."""
    kind = media.hetero_kind[i]
    x = jnp.sum(o * media.exp_dir[i], axis=-1) - media.exp_x0[i]
    dx = jnp.sum(d * media.exp_dir[i], axis=-1)
    pc = o - media.atm_center[i]
    t0 = jnp.sum(pc * d, axis=-1)
    h2 = jnp.maximum(jnp.sum(pc * pc, axis=-1) - t0 * t0, 0.0)
    sA = media.atm_s[i]
    eh = sA * sA * (h2 - media.atm_r2[i])
    return dict(kind=kind, x=x, dx=dx, t0=t0, s=sA, eh=eh,
                i=i, o=o, d=d, media=media)


_SQRT_PI = 1.7724538509055159
_INV_SQRT_PI = 0.5641895835477563


def _hetero_integral(hp, t):
    """int_0^t density ds for the lane's profile; exact for t = inf."""
    from jax.scipy.special import erf

    i_exp = _dens_integral(hp["x"], hp["dx"], t)
    inf = t >= 1e30
    u1 = jnp.where(inf, 0.0, hp["t0"] + t)  # placeholder where inf
    e1 = jnp.where(inf, 1.0, erf(hp["s"] * u1))
    i_atm = (
        (_SQRT_PI * 0.5 / jnp.maximum(hp["s"], 1e-30))
        * jnp.exp(-hp["eh"]) * (e1 - erf(hp["s"] * hp["t0"]))
    )
    out = jnp.where(hp["kind"] == 2, i_atm, i_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        zero = jnp.zeros_like(t)
        i_vox = grid_optical_depth(
            media.vox_grids[gi], hp["o"], hp["d"], zero, jnp.minimum(t, 1e30)
        )
        out = jnp.where((hp["kind"] == 3) & (hp["i"] == owner), i_vox, out)
    return out


def _hetero_density(hp, t):
    d_exp = jnp.exp(-(hp["x"] + hp["dx"] * t))
    u = hp["t0"] + t
    d_atm = jnp.exp(-(hp["eh"] + (hp["s"] * u) ** 2))
    out = jnp.where(hp["kind"] == 2, d_atm, d_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        p = hp["o"] + hp["d"] * t[..., None]
        d_vox = grid_density(media.vox_grids[gi], p)
        out = jnp.where((hp["kind"] == 3) & (hp["i"] == owner), d_vox, out)
    return out


def _hetero_inverse(hp, tau):
    """Smallest t with int_0^t density = tau (INF when unreachable)."""
    from jax.scipy.special import erf, erfinv

    t_exp = _inverse_optical_depth(hp["x"], hp["dx"], tau)
    inner = (
        erf(hp["s"] * hp["t0"])
        + 2.0 * _INV_SQRT_PI * jnp.exp(hp["eh"]) * hp["s"] * tau
    )
    t_atm = jnp.where(
        inner >= 1.0,
        INF,
        erfinv(jnp.clip(inner, -1.0 + 1e-7, 1.0 - 1e-7))
        / jnp.maximum(hp["s"], 1e-30) - hp["t0"],
    )
    out = jnp.where(hp["kind"] == 2, t_atm, t_exp)
    media = hp["media"]
    for gi, owner in enumerate(media.vox_owner):
        zero = jnp.zeros_like(tau)
        t_vox = grid_inverse_optical_depth(
            media.vox_grids[gi], hp["o"], hp["d"], zero,
            jnp.full_like(tau, 1e30), tau,
        )
        out = jnp.where((hp["kind"] == 3) & (hp["i"] == owner), t_vox, out)
    return out


def _hetero_far_ok(hp, far_t):
    """Absorption-only validity: exp profiles diverge on infinite rays
    unless decaying; the gaussian atmosphere always integrates finitely."""
    ok_exp = (far_t < INF) | (hp["dx"] > 0.0)
    bounded = (hp["kind"] == 2) | (hp["kind"] == 3)  # gaussian/grid: finite
    return jnp.where(bounded, True, jnp.where(hp["kind"] == 1, ok_exp, far_t < INF))


@pytree
class MediumSample:
    t: jnp.ndarray  # (N,) sampled distance (= far_t when exited)
    weight: jnp.ndarray  # (N, 3) throughput factor
    pdf: jnp.ndarray  # (N,)
    exited: jnp.ndarray  # (N,) bool — reached the surface
    scattered: jnp.ndarray  # (N,) bool — scatter event inside the medium
    p: jnp.ndarray  # (N, 3)
    emission: jnp.ndarray = None  # (N, 3) grid emission at the scatter point
    # continued free-flight (ignoring far_t), for photon planes
    # (HomogeneousMedium.cpp:86-100 continuedT/continuedWeight)
    continued_t: jnp.ndarray = None  # (N,)
    continued_weight: jnp.ndarray = None  # (N, 3)


def medium_sample_distance(
    media: MediumTable, mid, o, d, far_t, first_scatter, med_bounce, u_comp, u_dist, u_b,
    want_continued=False,
):
    """HomogeneousMedium::sampleDistance, batched. mid (N,) medium ids (lanes
    with mid < 0 are vacuum: exited with weight 1). With want_continued the
    sample also carries the UNBOUNDED free flight (continuedT) and its
    as-if-scattered weight (continuedWeight) for the photon-plane deposits."""
    i = jnp.maximum(mid, 0)
    sigma_t = media.sigma_t[i]
    sigma_s = media.sigma_s[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    abs_only = media.absorption_only[i]
    in_medium = mid >= 0

    # spectral channel choice
    comp = jnp.minimum((u_comp * 3).astype(jnp.int32), 2)
    sigma_tc = jnp.take_along_axis(sigma_t, comp[..., None], axis=-1)[..., 0]

    tau_sample = trans_sample(ttype, tparams, u_dist, u_b, first_scatter, present=media.trans_present)
    if media.has_hetero:
        # analytic heterogeneous density along the ray (ExponentialMedium /
        # AtmosphericMedium sampleDistance)
        hp = _hetero_ray(media, i, o, d)
        t_free = _hetero_inverse(hp, tau_sample / jnp.maximum(sigma_tc, 1e-20))
        exited = t_free >= far_t
        t = jnp.minimum(t_free, far_t)
        tau = _hetero_integral(hp, t)[..., None] * sigma_t
        rho = _hetero_density(hp, t)
    else:
        t_free = tau_sample / jnp.maximum(sigma_tc, 1e-20)
        exited = t_free >= far_t
        t = jnp.minimum(t_free, far_t)
        tau = t[..., None] * sigma_t
        rho = jnp.ones_like(t)
    sbar = _sigma_bar_full(ttype, tparams, media.trans_present)

    w_trans = trans_eval(ttype, tparams, tau, first_scatter, exited, present=media.trans_present)
    pdf_exit = jnp.mean(trans_surface_prob(ttype, tparams, tau, first_scatter, present=media.trans_present), axis=-1)
    pdf_scatter = rho * jnp.mean(sigma_t * trans_medium_pdf(ttype, tparams, tau, first_scatter, present=media.trans_present), axis=-1)
    pdf = jnp.where(exited, pdf_exit, pdf_scatter)
    w = jnp.where(exited[..., None], w_trans, w_trans * rho[..., None] * sigma_s * sbar[..., None])
    w = w / jnp.maximum(pdf, 1e-30)[..., None]
    # emission uses the PRE-scatter weight: trans_eval/pdf only, WITHOUT the
    # rho*sigmaS*sigmaBar factor (VoxelMedium.cpp:142-145 order)
    w_emis = w_trans / jnp.maximum(pdf, 1e-30)[..., None]

    # absorption-only media never scatter: deterministic transmittance to far_t
    if media.has_hetero:
        # infinite rays through decaying profiles still have finite depth
        far_finite = _hetero_far_ok(hp, far_t)
        tau_abs = _hetero_integral(hp, far_t)[..., None] * sigma_t
    else:
        far_finite = far_t < INF
        tau_abs = far_t[..., None] * sigma_t
    w_abs = trans_eval(
        ttype, tparams, tau_abs, first_scatter,
        jnp.ones_like(exited), present=media.trans_present,
    )
    t = jnp.where(abs_only, far_t, t)
    w = jnp.where(abs_only[..., None], w_abs, w)
    pdf = jnp.where(abs_only, 1.0, pdf)
    exited = jnp.where(abs_only, True, exited)
    # absorption-only + infinite ray: invalid (reference returns false)
    valid = in_medium & jnp.where(abs_only, far_finite, True)
    # max_bounce cut (reference returns false -> path ends)
    valid = valid & (med_bounce <= media.max_bounce[i])

    # vacuum lanes pass through
    t = jnp.where(in_medium, t, far_t)
    w = jnp.where(in_medium[..., None], w, 1.0)
    exited = exited | ~in_medium
    scattered = in_medium & ~exited & valid & ~abs_only

    p_end = o + d * t[..., None]
    w_final = jnp.where(valid[..., None], w, jnp.where(in_medium[..., None], 0.0, 1.0))
    # VoxelMedium.cpp:142: emission = grid emission at the scatter point
    # scaled by the (pdf-normalized) path weight
    emission = jnp.zeros_like(w_final)
    if media.has_emissive_grid:
        for gi, owner in enumerate(media.vox_owner):
            g = media.vox_grids[gi]
            if not g.has_emission:
                continue
            e = grid_emission(g, p_end) * jnp.where(valid[..., None], w_emis, 0.0)
            emission = jnp.where(
                (scattered & (i == owner))[..., None], e, emission
            )
    cont_t = None
    cont_w = None
    if want_continued:
        # continuedT/continuedWeight (HomogeneousMedium.cpp:86-100): the
        # unbounded free flight with its scatter weight
        #   sigma_s * sigma_bar * Tr(tau_c) / mean(sigma_t * pdf_med(tau_c))
        # using the REALIZED sample's exited flag in the transmittance eval,
        # exactly as the reference does.
        finite_c = (t_free < INF) & in_medium & ~abs_only & valid
        t_c = jnp.where(finite_c, t_free, 0.0)
        if media.has_hetero:
            tau_c = _hetero_integral(hp, t_c)[..., None] * sigma_t
            rho_c = _hetero_density(hp, t_c)
        else:
            tau_c = t_c[..., None] * sigma_t
            rho_c = jnp.ones_like(t_c)
        w_tc = trans_eval(ttype, tparams, tau_c, first_scatter, exited, present=media.trans_present)
        pdf_c = rho_c * jnp.mean(
            sigma_t * trans_medium_pdf(ttype, tparams, tau_c, first_scatter, present=media.trans_present),
            axis=-1,
        )
        cw = w_tc * rho_c[..., None] * sigma_s * sbar[..., None] / jnp.maximum(pdf_c, 1e-30)[..., None]
        cont_t = t_c
        cont_w = jnp.where(finite_c[..., None], cw, 0.0)
        cont_w = jnp.where(jnp.isfinite(cont_w), cont_w, 0.0)
    return MediumSample(
        t=t,
        weight=w_final,
        pdf=pdf,
        exited=exited & valid | ~in_medium,
        scattered=scattered,
        p=p_end,
        emission=emission,
        continued_t=cont_t,
        continued_weight=cont_w,
    )


def medium_distance_pdf(media: MediumTable, mid, o, d, t, start_on_surface,
                        end_on_surface):
    """Medium::pdf (HomogeneousMedium.cpp pdf cases): density of the
    distance sampler producing segment length `t` along (o, d), given the
    endpoint types. Used by BDPT to fold reverse-edge medium pdfs into the
    MIS products (PathVertex.cpp:161-163, LightPath.cpp:66-71). Vacuum
    lanes return 1."""
    i = jnp.maximum(mid, 0)
    sigma_t = media.sigma_t[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    if media.has_hetero:
        hp = _hetero_ray(media, i, o, d)
        tau = _hetero_integral(hp, t)[..., None] * sigma_t
        rho = _hetero_density(hp, t)
    else:
        tau = jnp.minimum(t, 1e30)[..., None] * sigma_t
        rho = jnp.ones_like(t)
    pdf_exit = jnp.mean(
        trans_surface_prob(ttype, tparams, tau, start_on_surface, present=media.trans_present),
        axis=-1,
    )
    pdf_scatter = rho * jnp.mean(
        sigma_t * trans_medium_pdf(ttype, tparams, tau, start_on_surface, present=media.trans_present),
        axis=-1,
    )
    pdf = jnp.where(end_on_surface, pdf_exit, pdf_scatter)
    pdf = jnp.where(media.absorption_only[i], 1.0, pdf)
    return jnp.where(mid >= 0, pdf, 1.0)


def medium_transmittance(media: MediumTable, mid, far_t, start_on_surface,
                         end_on_surface, o=None, d=None):
    """Medium::transmittance for shadow segments; mid < 0 -> 1. o/d enable
    the exponential-density line integral (ExponentialMedium::transmittance);
    homogeneous tables ignore them."""
    i = jnp.maximum(mid, 0)
    sigma_t = media.sigma_t[i]
    ttype = media.trans_type[i]
    tparams = media.trans_params[i]
    infinite = far_t >= INF
    if media.has_hetero and o is not None:
        hp = _hetero_ray(media, i, o, d)
        tau = _hetero_integral(hp, far_t)[..., None] * sigma_t
        infinite = infinite & ~_hetero_far_ok(hp, far_t)
    else:
        tau = jnp.minimum(far_t, 1e30)[..., None] * sigma_t
    tr = trans_eval(ttype, tparams, tau, start_on_surface, end_on_surface, present=media.trans_present)
    tr = jnp.where(infinite[..., None], 0.0, tr)
    return jnp.where((mid >= 0)[..., None], tr, 1.0)
