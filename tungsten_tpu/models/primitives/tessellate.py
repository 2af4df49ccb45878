"""Host-side tessellation of scene primitives into the unified triangle soup.

The reference intersects quads/cubes analytically (Quad.cpp:72-97,
Cube.cpp) and meshes through embree. The wavefront design flattens *all* finite
area primitives to triangles so one traversal kernel serves everything:
 - quad: 2 triangles over (base, edge0, edge1) with uv = (l0, l1) along the
   edges, winding chosen so the geometric normal equals the reference's
   normalize(edge1 x edge0) — emission sidedness depends on it;
 - cube: 12 triangles, outward normals, per-face unit uv;
 - mesh: .wo3/.obj data; `smooth` selects vertex normals vs face normals
   (TriangleMesh::_smoothed).
Spheres stay analytic (handled separately). Results are in LOCAL space;
flatten_scene applies the primitive transform.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TriSoup:
    pos: np.ndarray  # (V, 3)
    normal: Optional[np.ndarray]  # (V, 3) shading normals or None -> flat
    uv: np.ndarray  # (V, 2)
    indices: np.ndarray  # (F, 3)
    tangent: Optional[np.ndarray] = None  # (V, 3) fiber tangents (curves)


def quad() -> TriSoup:
    # corners: base, base+e0, base+e0+e1, base+e1 in local space where
    # base = -(e0+e1)/2, e0 = x axis, e1 = z axis (Quad::prepareForRender)
    c = np.array(
        [[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]], np.float32
    )
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    # winding (0,2,1),(0,3,2) makes cross(p1-p0, p2-p0) == normalize(e1 x e0)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return TriSoup(pos=c, normal=None, uv=uv, indices=idx)


def cube() -> TriSoup:
    pos, uv, idx = [], [], []
    # each face: (axis, sign); build so normals point outward
    for axis in range(3):
        for sign in (-1.0, 1.0):
            a = (axis + 1) % 3
            b = (axis + 2) % 3
            corners = np.zeros((4, 3), np.float32)
            quads_ab = [(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)]
            for i, (ua, ub) in enumerate(quads_ab):
                corners[i, axis] = 0.5 * sign
                corners[i, a] = ua
                corners[i, b] = ub
            base = len(pos)
            pos.extend(corners)
            uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            if sign > 0:
                idx.append([base + 0, base + 1, base + 2])
                idx.append([base + 0, base + 2, base + 3])
            else:
                idx.append([base + 0, base + 2, base + 1])
                idx.append([base + 0, base + 3, base + 2])
    return TriSoup(
        pos=np.asarray(pos, np.float32),
        normal=None,
        uv=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.int32),
    )


def sphere_mesh(subdiv: int = 32) -> TriSoup:
    """Lat-long tessellated unit sphere (fallback until analytic spheres)."""
    nu, nv = 2 * subdiv, subdiv
    us = np.linspace(0, 2 * np.pi, nu + 1)
    vs = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="xy")
    x = np.sin(vv) * np.cos(uu)
    z = np.sin(vv) * np.sin(uu)
    y = np.cos(vv)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu / (2 * np.pi), 1 - vv / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + 1
            c = a + (nu + 1)
            d = c + 1
            idx.append([a, b, d])
            idx.append([a, d, c])
    return TriSoup(
        pos=pos, normal=pos.copy(), uv=uv, indices=np.asarray(idx, np.int32)
    )


def disk(segments: int = 64) -> TriSoup:
    """Unit-radius disk in the local XZ plane, normal +Y (Disk.cpp:313-318:
    r = max(scale.xz), n = transform up; uv = (atan2-based angle, r/R) from
    Disk::intersectionInfo). Triangle fan, winding matching quad()'s so the
    geometric normal is +Y."""
    ang = np.arange(segments) * (2.0 * np.pi / segments)
    ring = np.stack([np.cos(ang), np.zeros(segments), np.sin(ang)], axis=1)
    pos = np.concatenate([[[0.0, 0.0, 0.0]], ring]).astype(np.float32)
    uv = np.zeros((segments + 1, 2), np.float32)
    uv[1:, 0] = ang / (2.0 * np.pi)
    uv[1:, 1] = 1.0
    idx = np.array(
        [[0, 1 + (i + 1) % segments, 1 + i] for i in range(segments)], np.int32
    )
    # verify winding gives +Y: (p1-p0) x (p2-p0) ~ +Y for ccw-in-xz fan
    p0, p1, p2 = pos[idx[0, 0]], pos[idx[0, 1]], pos[idx[0, 2]]
    if np.cross(p1 - p0, p2 - p0)[1] < 0:
        idx = idx[:, [0, 2, 1]]
    return TriSoup(pos=pos, normal=None, uv=uv, indices=idx)


def cylinder(segments: int = 64, capped: bool = True) -> TriSoup:
    """Capped cylinder: local radius 0.5, y in [-0.5, 0.5] so the generic
    transform yields radius = 0.5*scale.xz, halfHeight = 0.5*scale.y
    (Cylinder.cpp:133-141; the reference collapses non-uniform xz scale to
    max — we keep the ellipse). Smooth side normals, flat caps."""
    ang = np.arange(segments) * (2.0 * np.pi / segments)
    cx, sz = 0.5 * np.cos(ang), 0.5 * np.sin(ang)
    top = np.stack([cx, np.full(segments, 0.5), sz], axis=1)
    bot = np.stack([cx, np.full(segments, -0.5), sz], axis=1)
    n_side = np.stack([np.cos(ang), np.zeros(segments), np.sin(ang)], axis=1)
    pos = [top, bot]
    nrm = [n_side, n_side]
    uv = [np.stack([ang / (2 * np.pi), np.ones(segments)], 1),
          np.stack([ang / (2 * np.pi), np.zeros(segments)], 1)]
    idx = []
    for i in range(segments):
        j = (i + 1) % segments
        # outward winding: normal ~ radial
        idx.append([i, segments + j, segments + i])
        idx.append([i, j, segments + j])
    base = 2 * segments
    if capped:
        pos += [top, bot]
        nrm += [np.tile([[0.0, 1.0, 0.0]], (segments, 1)),
                np.tile([[0.0, -1.0, 0.0]], (segments, 1))]
        uv += [np.stack([cx + 0.5, sz + 0.5], 1), np.stack([cx + 0.5, sz + 0.5], 1)]
        for i in range(1, segments - 1):
            idx.append([base, base + i + 1, base + i])  # top cap, +y out
            idx.append([base + segments, base + segments + i,
                        base + segments + i + 1])  # bottom cap, -y out
    pos = np.concatenate(pos).astype(np.float32)
    nrm = np.concatenate(nrm).astype(np.float32)
    uv = np.concatenate(uv).astype(np.float32)
    idx = np.asarray(idx, np.int32)
    # fix winding so geometric normals match shading normals (outward)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    ng = np.cross(p1 - p0, p2 - p0)
    flip = np.einsum("ij,ij->i", ng, nrm[idx[:, 0]]) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return TriSoup(pos=pos, normal=nrm, uv=uv, indices=idx)


def curve_tubes(curve_ends, nodes, sides: int = 3, taper: bool = False,
                subsample: float = 1.0, max_tris: int = 1 << 20,
                seed: int = 0x5EED) -> TriSoup:
    """Tessellate curve strands (Curves.cpp modes cylinder / half_cylinder /
    bcsdf_cylinder / ribbon all become thin tubes here) into `sides`-gonal
    tubes with per-node radius and optional tip taper. `subsample` keeps that
    fraction of strands (Curves.cpp "subsample"); an additional stride is
    applied if the result would exceed max_tris (the wavefront intersector
    scales with triangle count, not strand count)."""
    curve_ends = np.asarray(curve_ends, np.int64)
    nodes = np.asarray(nodes, np.float32)
    starts = np.concatenate([[0], curve_ends[:-1]])
    n_curves = len(curve_ends)
    keep = np.arange(n_curves)
    if subsample < 1.0:
        rng = np.random.default_rng(seed)
        keep = keep[rng.random(n_curves) < subsample]
    seg_total = int((curve_ends - starts - 1)[keep].clip(min=0).sum())
    est_tris = seg_total * sides * 2
    if est_tris > max_tris:
        stride = int(np.ceil(est_tris / max_tris))
        import warnings

        warnings.warn(
            f"curve tessellation budget: {est_tris} tris exceed max_tris="
            f"{max_tris}; keeping every {stride}-th strand "
            f"({len(keep[::stride])}/{len(keep)}). The reference renders "
            f"every strand (Curves.cpp has no such cap) — raise the "
            f"primitive's 'max_tris' to keep full geometry.",
            stacklevel=2)
        keep = keep[::stride]

    pos_l, nrm_l, idx_l, uv_l, tan_l = [], [], [], [], []
    ang = np.arange(sides) * (2.0 * np.pi / sides)
    ca, sa = np.cos(ang), np.sin(ang)
    base = 0
    for ci in keep:
        s, e = int(starts[ci]), int(curve_ends[ci])
        pts = nodes[s:e, :3]
        rad = nodes[s:e, 3].copy()
        m = len(pts)
        if m < 2:
            continue
        if taper:
            rad *= np.linspace(1.0, 0.0, m, dtype=np.float32)
        # propagate a frame down the strand (cheap parallel transport)
        tang = np.diff(pts, axis=0)
        tang = np.concatenate([tang, tang[-1:]])
        tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
        up = np.array([0.0, 1.0, 0.0])
        n0 = np.cross(tang[0], up)
        if np.linalg.norm(n0) < 1e-6:
            n0 = np.cross(tang[0], [1.0, 0.0, 0.0])
        n0 /= np.linalg.norm(n0)
        rings_p, rings_n, rings_t = [], [], []
        nrm = n0
        for k in range(m):
            nrm = nrm - tang[k] * np.dot(nrm, tang[k])
            ln = np.linalg.norm(nrm)
            nrm = n0 if ln < 1e-9 else nrm / ln
            bt = np.cross(tang[k], nrm)
            ring_n = nrm[None, :] * ca[:, None] + bt[None, :] * sa[:, None]
            rings_n.append(ring_n)
            rings_t.append(np.tile(tang[k][None, :], (sides, 1)))
            rings_p.append(pts[k][None, :] + ring_n * max(rad[k], 1e-6))
        rp = np.concatenate(rings_p)
        rn = np.concatenate(rings_n)
        pos_l.append(rp)
        nrm_l.append(rn)
        tan_l.append(np.concatenate(rings_t))
        uv_l.append(np.stack([np.tile(ang / (2 * np.pi), m),
                              np.repeat(np.linspace(0, 1, m), sides)], 1))
        for k in range(m - 1):
            r0 = base + k * sides
            r1 = r0 + sides
            for j in range(sides):
                j1 = (j + 1) % sides
                idx_l.append([r0 + j, r1 + j1, r1 + j])
                idx_l.append([r0 + j, r0 + j1, r1 + j1])
        base += m * sides
    if not pos_l:
        return TriSoup(pos=np.zeros((0, 3), np.float32), normal=None,
                       uv=np.zeros((0, 2), np.float32),
                       indices=np.zeros((0, 3), np.int32))
    pos = np.concatenate(pos_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    uv = np.concatenate(uv_l).astype(np.float32)
    tan = np.concatenate(tan_l).astype(np.float32)
    idx = np.asarray(idx_l, np.int32)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    ng = np.cross(p1 - p0, p2 - p0)
    flip = np.einsum("ij,ij->i", ng, nrm[idx[:, 0]]) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return TriSoup(pos=pos, normal=nrm, uv=uv, indices=idx, tangent=tan)
