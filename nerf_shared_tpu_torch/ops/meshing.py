"""Mesh extraction from a trained density field.

Counterpart of ``nerf_shared_tpu/ops/meshing.py`` (the original NeRF
release's ``extract_mesh`` notebook: a dense sigma probe, then an
isosurface at iso = 50), in two stages:

1. ``probe_density_grid``: raw (pre-ReLU) sigma on the (R+1)³ lattice of
   the box, through the renderer's model seam (``_apply_model``: kernel B1
   under ``use_pallas`` on CUDA tensors, P1 for the grid families). Each
   block's lattice points are generated on the device from its start
   index, so the (R+1)³ cloud never materialises.
2. ``marching_tetrahedra``: host-side. The cell scan runs in the port's
   own OpenMP C++ library (ops/native_meshing.py, ``csrc/host/meshing.cpp``)
   or the vectorised numpy scan (``_numpy_scan``); both emit the same face
   set, and the vertex dedup per lattice edge and the crossing
   interpolation are shared numpy (``_dedup_and_interp``). Marching
   tetrahedra needs a 16-case table and gives a watertight, consistently
   wound surface.

``density_gradient_normals`` differentiates sigma through the same seam
(B1 forward and B2 backward under ``use_pallas``), ``vertex_colors`` bakes
the radiance viewed along each vertex normal (B1 on [V, 1] points), the NDC
helpers unwarp forward-facing meshes, and ``save_obj`` / ``save_ply`` write
the files byte for byte as the JAX package does. With ``mesh=`` (a
``parallel.distributed.World``) the probe's blocks split over the ranks and
the sigma gathers back to every rank, as JAX shards it over its mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from nerf_shared_tpu_torch.ops import native_meshing
from nerf_shared_tpu_torch.parallel.distributed import gather_rows
from nerf_shared_tpu_torch.render.occupancy import _device_of
from nerf_shared_tpu_torch.render.renderer import _apply_model


def _dummy_dirs(cfg, device):
    """The fixed view direction of the density probes (sigma does not read
    it), or None for a network without a viewdir head."""
    if not getattr(cfg, "use_viewdirs", True):
        return None
    return torch.full((1, 3), 1.0 / math.sqrt(3.0), dtype=torch.float32, device=device)


# -----------------------------------------------------------------------------
# Stage 1: device-side density probe
# -----------------------------------------------------------------------------


@torch.no_grad()
def probe_density_grid(params, cfg, rcfg, aabb_min, aabb_max,
                       resolution: int = 256, block: int = 65536,
                       mesh=None) -> np.ndarray:
    """Raw (pre-ReLU) sigma at the ``(R+1)^3`` lattice of box corner points,
    as a host float32 array [R+1, R+1, R+1]. Pre-ReLU values give marching
    tetrahedra a signed interpolation target below the surface. The
    lattice goes through the network in blocks of ``block`` points (one
    "ray" of ``block`` samples each; the padded tail re-probes the last
    corner).

    With ``mesh`` (a ``parallel.distributed.World``) the block count is
    padded to a multiple of the world size, rank r sweeps its contiguous
    blocks and the sigma is gathered to every rank (the network
    replicated; the gather the only collective). A world of one is the
    unsharded probe bit for bit."""
    device = _device_of(params)
    r = int(resolution)
    r1 = r + 1
    n = r1 ** 3
    block = min(block, n)
    n_blocks = -(-n // block)
    size = mesh.size if mesh is not None else 1
    n_blocks = -(-n_blocks // size) * size
    per = n_blocks // size
    first = (mesh.rank if mesh is not None else 0) * per
    lo = torch.as_tensor(np.asarray(aabb_min, np.float32), device=device).reshape(3)
    hi = torch.as_tensor(np.asarray(aabb_max, np.float32), device=device).reshape(3)
    dirs = _dummy_dirs(cfg, device)
    offs = torch.arange(block, dtype=torch.int64, device=device)
    sigma = torch.empty(per * block, dtype=torch.float32, device=device)
    for j in range(per):
        idx = torch.clamp((first + j) * block + offs, max=n - 1)
        ijk = torch.stack([idx // (r1 * r1), (idx // r1) % r1, idx % r1], -1)
        pts = lo + ijk.to(torch.float32) / r * (hi - lo)
        raw = _apply_model(params, cfg, pts[None], dirs, rcfg)
        sigma[j * block:(j + 1) * block] = raw[0, :, 3]
    sigma = gather_rows(sigma, n, mesh)
    return sigma[:n].cpu().numpy().reshape(r1, r1, r1)


# -----------------------------------------------------------------------------
# Stage 2: host-side marching tetrahedra
# -----------------------------------------------------------------------------

# Cube corner offsets (x, y, z); the 6-tetrahedron decomposition around the
# main diagonal c0-c6 is face-consistent across neighboring cubes (each
# shared cube face is split by the same diagonal from both sides), which is
# what makes the global surface watertight.
_CUBE_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)
_TETS_RAW = [
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
]


def _oriented_tets():
    """The 6 cube tetrahedra, each permuted to positive signed volume so a
    single winding table applies to all of them."""
    out = []
    for t in _TETS_RAW:
        p = _CUBE_CORNERS[list(t)].astype(np.float64)
        vol = np.linalg.det(p[1:] - p[0])
        out.append(t if vol > 0 else (t[0], t[1], t[3], t[2]))
    return out


_TETS = _oriented_tets()

# Local tet edges; triangle tables index into this list.
_TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64
)

# case id = sum(inside[v] << v) -> triangles as triples of edge ids, wound so
# the normal points from the inside region (value > iso) outward. Derived for
# a positively oriented tet; verified by the gradient-alignment test in
# tests/test_meshing.py (the port: tests/test_torch_meshing.py).
_TRI_TABLE = {
    1: [(0, 1, 2)],
    2: [(0, 4, 3)],
    3: [(1, 4, 3), (1, 2, 4)],
    4: [(1, 3, 5)],
    5: [(0, 3, 5), (0, 5, 2)],
    6: [(0, 4, 5), (0, 5, 1)],
    7: [(2, 4, 5)],
    8: [(2, 5, 4)],
    9: [(0, 5, 4), (0, 1, 5)],
    10: [(0, 5, 3), (0, 2, 5)],
    11: [(1, 5, 3)],
    12: [(1, 3, 4), (1, 4, 2)],
    13: [(0, 3, 4)],
    14: [(0, 2, 1)],
}


def scan_route(native: str = "auto") -> str:
    """Which cell scan ``native`` selects: "native" (the C++ library) or
    "numpy". "auto" takes the library when it builds, "never" the numpy
    scan, "require" the library or raises."""
    if native not in ("auto", "never", "require"):
        raise ValueError(f"native={native!r}: use 'auto', 'never' or 'require'")
    if native != "never" and native_meshing.available():
        return "native"
    if native == "require":
        raise RuntimeError("native meshing library unavailable (g++ failed "
                           "building csrc/host/meshing.cpp)")
    return "numpy"


def marching_tetrahedra(
    values: np.ndarray,
    iso: float,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    slab: int = 64,
    native: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a scalar lattice field at level ``iso``.

    values : [X, Y, Z] scalar samples at lattice points; lattice point
        (i, j, k) lies at origin + spacing * (i, j, k).
    slab : cubes per z-slab of the numpy scan (bounds its peak memory).
    native : the cell scan (``scan_route``); both give the same face set.

    Returns (verts [V, 3] fp32, faces [F, 3] int32), vertices deduplicated
    per lattice edge, triangles wound counter-clockwise seen from outside
    (normals point toward decreasing field value).
    """
    values = np.asarray(values, np.float32)
    if values.ndim != 3 or min(values.shape) < 2:
        raise ValueError(f"need a [X>=2, Y>=2, Z>=2] lattice, got {values.shape}")
    if scan_route(native) == "native":
        lo, hi = native_meshing.mt_scan(values, iso)
    else:
        lo, hi = _numpy_scan(values, iso, slab)
    return _dedup_and_interp(lo, hi, values, iso, origin, spacing)


def _numpy_scan(values: np.ndarray, iso: float, slab: int):
    """Vectorized cube scan: returns flat (lo, hi) lattice-index arrays of
    length 3*T, one entry per triangle corner (winding order preserved)."""
    X, Y, Z = values.shape
    flat = values.ravel()
    lattice_idx = np.arange(X * Y * Z, dtype=np.int64).reshape(X, Y, Z)

    # Per emitted triangle corner: global lattice indices (gi, gj) of the
    # crossed edge, accumulated per slab then deduplicated once at the end.
    tri_gi, tri_gj = [], []

    for z0 in range(0, Z - 1, slab):
        z1 = min(z0 + slab, Z - 1)  # cubes [z0, z1)
        # [C, 8] global lattice index of each cube corner in this slab
        corner_idx = np.stack(
            [
                lattice_idx[dx:X - 1 + dx, dy:Y - 1 + dy,
                            z0 + dz:z1 + dz].ravel()
                for dx, dy, dz in _CUBE_CORNERS
            ],
            axis=1,
        )
        vals8 = flat[corner_idx]  # [C, 8]

        for tet in _TETS:
            ti = corner_idx[:, list(tet)]          # [C, 4]
            tv = vals8[:, list(tet)]               # [C, 4]
            inside = tv > iso
            case = (
                inside[:, 0].astype(np.int8)
                + (inside[:, 1] << 1)
                + (inside[:, 2] << 2)
                + (inside[:, 3] << 3)
            )
            for case_id, tris in _TRI_TABLE.items():
                sel = np.nonzero(case == case_id)[0]
                if sel.size == 0:
                    continue
                ti_sel = ti[sel]
                for tri in tris:
                    ev = _TET_EDGES[list(tri)]     # [3, 2] local vert ids
                    tri_gi.append(ti_sel[:, ev[:, 0]])  # [S, 3]
                    tri_gj.append(ti_sel[:, ev[:, 1]])

    if not tri_gi:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))

    gi = np.concatenate(tri_gi, axis=0)  # [T, 3]
    gj = np.concatenate(tri_gj, axis=0)
    return np.minimum(gi, gj).ravel(), np.maximum(gi, gj).ravel()


def _dedup_and_interp(lo, hi, values, iso, origin, spacing):
    """Shared tail of both scans: vertex dedup by undirected lattice edge,
    crossing interpolation, world-space placement, degenerate-face drop."""
    X, Y, Z = values.shape
    flat = values.ravel()
    if len(lo) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    keys = lo * np.int64(X * Y * Z) + hi
    uniq, inverse = np.unique(keys, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)

    # Interpolate each unique edge's crossing once.
    ulo = (uniq // (X * Y * Z)).astype(np.int64)
    uhi = (uniq % (X * Y * Z)).astype(np.int64)
    vlo, vhi = flat[ulo], flat[uhi]
    # endpoints straddle iso strictly on one side (inside is v > iso), so
    # the denominator is nonzero by construction
    t = np.clip((iso - vlo) / (vhi - vlo), 0.0, 1.0)[:, None]

    origin = np.asarray(origin, np.float32)
    spacing = np.asarray(spacing, np.float32)

    def lattice_pos(g):
        i = g // (Y * Z)
        j = (g // Z) % Y
        k = g % Z
        return origin + spacing * np.stack([i, j, k], axis=-1).astype(np.float32)

    verts = lattice_pos(ulo) * (1.0 - t) + lattice_pos(uhi) * t

    # Drop degenerate triangles (two corners on the same lattice edge —
    # happens when a tet face lies exactly in the iso plane).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[ok]


def extract_mesh(params, cfg, rcfg, aabb_min, aabb_max, resolution: int = 256,
                 iso: float = 50.0, block: int = 65536,
                 sigma_grid: Optional[np.ndarray] = None, mesh=None,
                 native: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
    """Probe the field on the device, then isosurface on the host. ``iso``
    is on raw pre-ReLU sigma (the original NeRF export's 50);
    ``sigma_grid`` reuses an already probed lattice. With ``mesh`` (a
    World) the probe is sharded (``probe_density_grid``) and every rank
    that calls it isosurfaces the gathered lattice."""
    if sigma_grid is None:
        sigma_grid = probe_density_grid(params, cfg, rcfg, aabb_min, aabb_max,
                                        resolution=resolution, block=block, mesh=mesh)
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    dims = np.asarray(sigma_grid.shape, np.float32)
    spacing = (aabb_max - aabb_min) / (dims - 1.0)
    return marching_tetrahedra(sigma_grid, iso, origin=aabb_min, spacing=spacing,
                               native=native)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (host-side numpy). Faces are wound
    outward by ``marching_tetrahedra``, so these point out of the surface."""
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )  # |fn| = 2 * area: accumulating unnormalized = area weighting
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def density_gradient_normals(params, cfg, rcfg, verts: np.ndarray,
                             block: int = 65536) -> np.ndarray:
    """Per-vertex normals from the density field: n = -∇σ / |∇σ| (density
    grows into the surface). σ at a point depends on that point only, so
    the gradient of the block's sum of σ gives every point's gradient in
    one backward. It runs on the route ``rcfg`` selects (under
    ``use_pallas`` kernel B1 forward and B2 backward for the MLP)."""
    if len(verts) == 0:
        return np.zeros((0, 3), np.float32)
    device = _device_of(params)
    params = {k: v.detach() for k, v in params.items()}
    dirs = _dummy_dirs(cfg, device)
    pts_all = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    out = []
    for i in range(0, pts_all.shape[0], block):
        with torch.enable_grad():
            p = pts_all[i:i + block].clone().requires_grad_(True)
            raw = _apply_model(params, cfg, p[None], dirs, rcfg)
            (g,) = torch.autograd.grad(raw[0, :, 3].sum(), p)
        out.append(-g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12))
    return torch.cat(out).cpu().numpy().astype(np.float32)


@torch.no_grad()
def vertex_colors(params, cfg, rcfg, verts: np.ndarray, faces: np.ndarray,
                  block: int = 65536, normals: Optional[np.ndarray] = None) -> np.ndarray:
    """Radiance at each vertex viewed head-on (the view direction is the
    negated outward normal; default the area-weighted face normals), through
    the compositor's sigmoid: [V, 3] in [0, 1]. Each vertex is one ray of
    one sample with its own view direction."""
    if len(verts) == 0:
        return np.zeros((0, 3), np.float32)
    if normals is None:
        normals = vertex_normals(verts, faces)
    device = _device_of(params)
    use_vd = getattr(cfg, "use_viewdirs", True)
    pts_all = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    dirs_all = torch.as_tensor(np.asarray(-normals, np.float32), device=device)
    out = []
    for i in range(0, pts_all.shape[0], block):
        d = dirs_all[i:i + block].contiguous() if use_vd else None
        raw = _apply_model(params, cfg, pts_all[i:i + block, None].contiguous(), d, rcfg)
        out.append(torch.sigmoid(raw[:, 0, :3]))
    return torch.cat(out).cpu().numpy().astype(np.float32)


# -----------------------------------------------------------------------------
# NDC unwarp (LLFF forward-facing scenes)
# -----------------------------------------------------------------------------


def ndc_points_to_world(
    pts: np.ndarray,
    H: int,
    W: int,
    focal: float,
    near: float = 1.0,
    z_clip: float = 0.999,
) -> np.ndarray:
    """Invert the projective NDC warp for POINTS (host-side numpy).

    ``ops/rays.ndc_rays`` (reference utils.py:54-71) maps a world point
    ``p`` (camera-facing, ``p_z < 0``) to ``(-2f/W * p_x/p_z,
    -2f/H * p_y/p_z, 1 + 2n/p_z)``, so the exact inverse is
    ``p_z = 2n/(z'-1)``, ``p_x = -x' * p_z * W/(2f)``, ``p_y = -y' * p_z
    * H/(2f)``. NDC ``z'`` approaches 1 at infinite depth — vertices are
    clipped to ``z' <= z_clip`` (depth ``2n/(1-z_clip)``) so far-plane
    geometry lands on a finite far shell instead of exploding."""
    pts = np.asarray(pts, np.float32)
    zp = np.minimum(pts[:, 2], np.float32(z_clip))
    wz = 2.0 * near / (zp - 1.0)
    wx = -pts[:, 0] * wz * W / (2.0 * focal)
    wy = -pts[:, 1] * wz * H / (2.0 * focal)
    return np.stack([wx, wy, wz], axis=-1).astype(np.float32)


def ndc_normals_to_world(
    pts_ndc: np.ndarray,
    normals_ndc: np.ndarray,
    H: int,
    W: int,
    focal: float,
    near: float = 1.0,
    z_clip: float = 0.999,
) -> np.ndarray:
    """Transform level-set NORMALS through the NDC unwarp.

    The density lives on NDC coordinates, so its isosurface normal is an
    NDC-space gradient; gradients are covariant, i.e. ``n_world =
    J^T n_ndc`` where ``J`` is the Jacobian of the world->NDC map at the
    world point (NOT the plain inverse map applied to the vector). This
    keeps ``-grad sigma`` pointing out of the unwarped surface."""
    p = ndc_points_to_world(pts_ndc, H, W, focal, near, z_clip)
    a = 2.0 * focal / W
    b = 2.0 * focal / H
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    nx = np.asarray(normals_ndc[:, 0], np.float32)
    ny = np.asarray(normals_ndc[:, 1], np.float32)
    nz = np.asarray(normals_ndc[:, 2], np.float32)
    wx = -a / pz * nx
    wy = -b / pz * ny
    wz = (a * px * nx + b * py * ny - 2.0 * near * nz) / (pz * pz)
    n = np.stack([wx, wy, wz], axis=-1)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


# -----------------------------------------------------------------------------
# Export
# -----------------------------------------------------------------------------


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray = None, normals: np.ndarray = None) -> None:
    """Wavefront OBJ (ASCII, 1-indexed faces). Vertex colors use the
    widely supported unofficial extension: `v x y z r g b`; normals are
    standard `vn` lines with `f v//vn` faces (per-vertex, same index)."""
    with open(path, "w") as f:
        f.write(f"# nerf_shared_tpu mesh: {len(verts)} verts, "
                f"{len(faces)} faces\n")
        if colors is None:
            np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        else:
            np.savetxt(f, np.concatenate([verts, colors], axis=1),
                       fmt="v %.6f %.6f %.6f %.4f %.4f %.4f")
        if normals is None:
            np.savetxt(f, faces + 1, fmt="f %d %d %d")
        else:
            np.savetxt(f, normals, fmt="vn %.6f %.6f %.6f")
            np.savetxt(f, np.repeat(faces + 1, 2, axis=1),
                       fmt="f %d//%d %d//%d %d//%d")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray = None, normals: np.ndarray = None) -> None:
    """Binary little-endian PLY, optionally with float vertex normals
    and/or uchar vertex colors (standard property order: xyz, normals,
    colors)."""
    fields = [("xyz", "<f4", (3,))]
    props = "property float x\nproperty float y\nproperty float z\n"
    if normals is not None:
        fields.append(("n", "<f4", (3,)))
        props += ("property float nx\nproperty float ny\n"
                  "property float nz\n")
    if colors is not None:
        fields.append(("rgb", "u1", (3,)))
        props += ("property uchar red\nproperty uchar green\n"
                  "property uchar blue\n")
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        + props
        + f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    vrec = np.zeros(len(verts), dtype=fields)
    vrec["xyz"] = verts
    if normals is not None:
        vrec["n"] = normals
    if colors is not None:
        vrec["rgb"] = np.clip(np.asarray(colors) * 255.0 + 0.5, 0, 255)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vrec.tobytes())
        body = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        body["n"] = 3
        body["idx"] = faces.astype("<i4")
        f.write(body.tobytes())


def save_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray = None, normals: np.ndarray = None) -> None:
    """Dispatch on extension (.obj / .ply)."""
    if path.endswith(".obj"):
        save_obj(path, verts, faces, colors, normals)
    elif path.endswith(".ply"):
        save_ply(path, verts, faces, colors, normals)
    else:
        raise ValueError(f"unsupported mesh format: {path} (.obj or .ply)")
