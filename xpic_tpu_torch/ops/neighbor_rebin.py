"""Neighbor-exchange particle migration (the fast rebin)
(counterpart of ``xpic_tpu/ops/neighbor_rebin.py``).

Under the CFL guard a particle moves at most one cell per axis per
step, so the migration is a dimension-split exchange with the
neighbor cells:

1. **partition sort** (PyTorch): each row is stably sorted into
   [stayers | dead | movers]; the last AT columns then hold every mover,
   and the mover buffer ``[G, 8, AT]`` (channels rx, ry, rz, px, py, pz,
   valid, 0) is a static slice.
2. **three axis passes** (x, y, z) over the buffer only.  Each pass runs
   the extract kernel (classify +1 / -1 / stay along the axis with
   periodic wrap; left-compact the residents in place and the movers
   into ``[G, 8, A]`` direction buffers, A = 8) and the place kernel
   (append the arrivals read from the neighbor cells' direction
   buffers after each cell's residents).  Multi-axis movers ride the
   buffer through all passes.
3. **static tail merge** (PyTorch): the buffer leaves the passes
   left-compacted, so lane q is arrival rank q and enters its row at
   column K-1-q, free whenever K-1-q >= n_stay.

The guard (:func:`neighbor_guard_stats`) is exact: it simulates the
buffer routing at the counting level, so any step the exchange could not
route losslessly takes the global sort instead.

On a z slab (``geom.mesh``) the x and y passes run on the slab as they
are.  The z pass classifies against the slab's own planes: the buffer's
z channel is stashed in its spare channel 7 and replaced by the slab
plane each mover goes to, wrapped around the slab, so that the extract
kernel's periodic +1 / -1 classes are the moves across the slab faces
as well.  The up and down buffers then take one ghost plane each from
the neighbour ranks (the movers that leave them across the face), the
place kernel reads the z neighbours there without wrap (its ``zghost``
form), and channel 7 goes back into the z channel.

The extract and place kernels are hand-written CUDA
(``csrc/rebin_extract.cu``, ``csrc/rebin_place.cu``); ``extract_plain``
and ``place_plain`` are their PyTorch twins, taken for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import PERIODIC, Geometry
from .binning import BinnedState, _cell_centers, state_cell_ids
from ..parallel.mesh import mesh_of, z0_of, nz_global_of

# Payload channels of the mover buffer.
CHANNELS = 8
_VALID_CH = 6


def _mover_cols(K: int) -> int:
    """Mover-buffer columns per direction per cell (A).  A step that
    would exceed A anywhere is caught by the exact guard."""
    return 8


def _buffer_cols(K: int) -> int:
    """Total mover-buffer columns AT: ceil(K/3) rounded up to 8 (at
    least 16), bumped to the next power of two when that fits in K."""
    at = min(K, max(16, (-(-K // 3) + 7) // 8 * 8))
    p2 = 1 << (at - 1).bit_length()
    if p2 <= K:
        at = p2
    return at


# Axis metadata: (payload channel == axis id, spatial axis in the
# [nz, ny, nx] grid view, extent).  Flat cell ids are x-major:
# g = (cz * ny + cy) * nx + cx.
def _axes(geom: Geometry):
    return (
        (0, 2, geom.nx),
        (1, 1, geom.ny),
        (2, 0, geom.nz),
    )


def _home_coord(geom: Geometry, axis: int, device) -> torch.Tensor:
    g = torch.arange(geom.n_cells, dtype=torch.int64, device=device)
    if axis == 0:
        return g % geom.nx
    if axis == 1:
        return (g // geom.nx) % geom.ny
    return g // (geom.nx * geom.ny)


def _global_axis(geom: Geometry, axis: int, device):
    """``(home, n)``: each cell's global coordinate along ``axis`` and
    the global extent (the slab's z origin added on a slab)."""
    home = _home_coord(geom, axis, device)
    if axis == 2:
        return home + z0_of(geom), nz_global_of(geom)
    return home, (geom.nx, geom.ny)[axis]


# -- plain twins of the two kernels ----------------------------------------


def _compact_left(P, m):
    """Stable left-compaction of the masked lanes of ``P`` [G, C, L]:
    masked lanes land at 0..n-1 in source order, every other lane 0."""
    L = P.shape[-1]
    lane = torch.arange(L, device=P.device)
    key = torch.where(m, lane, lane + L)
    _, perm = torch.sort(key, dim=-1)
    moved = torch.gather(P, 2, perm[:, None, :].expand_as(P))
    keep = (lane[None, :] < m.sum(dim=-1, keepdim=True))[:, None, :]
    return torch.where(keep, moved, torch.zeros_like(moved))


def extract_plain(P, geom: Geometry, axis_ch: int):
    """Twin of the extract kernel: classify each live lane of the buffer
    ``P`` [G, 8, AT] as +1, -1 or stay along ``axis_ch`` (periodic wrap;
    ``n_ax == 2`` has no minus class) and compact each class.  Returns
    ``(residents [G, 8, AT], up [G, 8, A], dn [G, 8, A])``."""
    n_ax = (geom.nx, geom.ny, geom.nz)[axis_ch]
    A = _mover_cols(P.shape[-1])
    home = _home_coord(geom, axis_ch, P.device)[:, None]
    valid = P[:, _VALID_CH, :] > 0.5
    # floor == truncation: buffer positions are >= 0
    c = torch.clamp(P[:, axis_ch, :].to(torch.int64), 0, n_ax - 1)
    plus = valid & (c == torch.where(home + 1 == n_ax, 0, home + 1))
    if n_ax == 2:
        minus = torch.zeros_like(plus)
    else:
        minus = valid & (c == torch.where(home == 0, n_ax - 1, home - 1))
    stay = valid & ~plus & ~minus
    return (_compact_left(P, stay), _compact_left(P, plus)[:, :, :A],
            _compact_left(P, minus)[:, :, :A])


def _roll_cells(D, geom: Geometry, grid_axis: int, shift: int):
    """Roll a per-cell buffer [G, C, A] by ``shift`` cells along one
    axis of the [nz, ny, nx] grid (always periodic, as the extract
    classification wraps)."""
    G, C, A = D.shape
    V = D.reshape(geom.nz, geom.ny, geom.nx, C, A)
    return torch.roll(V, shift, dims=grid_axis).reshape(G, C, A)


def _shift_right(D, v, L: int):
    """out[..., j] = D[..., j - v] for 0 <= j - v < A, else 0, over
    L lanes; ``v`` is a per-cell [G] count."""
    G, C, A = D.shape
    j = torch.arange(L, device=D.device)[None, :] - v[:, None]
    ok = (j >= 0) & (j < A)
    src = torch.gather(D, 2, torch.clamp(j, 0, A - 1)[:, None, :]
                       .expand(G, C, L))
    return torch.where(ok[:, None, :], src, torch.zeros_like(src))


def place_plain(P, up, dn, geom: Geometry, axis_ch: int,
                zghost: bool = False):
    """Twin of the place kernel: each cell appends the up-arrivals of
    its -1 neighbor along the axis, then the down-arrivals of its +1
    neighbor, after its left-compacted residents; whatever passes the
    AT lanes is dropped.  ``zghost`` (z pass on a slab): ``up`` carries
    a ghost plane below the slab and ``dn`` one above, read without
    wrap."""
    grid_axis = 2 - axis_ch
    if zghost:
        G = P.shape[0]
        up_nb, dn_nb = up[:G], dn[geom.nx * geom.ny:]
    else:
        up_nb = _roll_cells(up, geom, grid_axis, +1)
        dn_nb = _roll_cells(dn, geom, grid_axis, -1)
    L = P.shape[-1]
    n_res = P[:, _VALID_CH, :].to(torch.int64).sum(dim=-1)
    a_up = up_nb[:, _VALID_CH, :].to(torch.int64).sum(dim=-1)
    return (P + _shift_right(up_nb, n_res, L)
            + _shift_right(dn_nb, n_res + a_up, L))


# -- kernel wrappers --------------------------------------------------------


def _check_at(AT: int):
    """The kernels take every width :func:`_buffer_cols` returns for
    K <= 512: a power of two from 8 to 256 (AT > 32 in 32-column chunks
    with carried ranks)."""
    if AT not in (8, 16, 32, 64, 128, 256):
        raise ValueError(
            f"rebin kernels take a power-of-two buffer width AT in 8..256, "
            f"got {AT}")


def rebin_extract(P, geom: Geometry, axis_ch: int):
    """Extract pass: the CUDA kernel for a CUDA float32 buffer, the
    plain twin for a CPU buffer; raises otherwise."""
    if P.device.type == "cpu":
        return extract_plain(P, geom, axis_ch)
    if P.device.type != "cuda":
        raise RuntimeError(f"rebin_extract: unsupported device {P.device}")
    G, C, AT = P.shape
    A = _mover_cols(AT)
    _check_at(AT)
    kernels.check_operand("rebin_extract", P, (geom.n_cells, CHANNELS, AT))
    out = torch.empty_like(P)
    up = torch.empty((G, C, A), dtype=P.dtype, device=P.device)
    dn = torch.empty_like(up)
    n_ax = (geom.nx, geom.ny, geom.nz)[axis_ch]
    kernels.call("rebin_extract", P.data_ptr(), out.data_ptr(),
                 up.data_ptr(), dn.data_ptr(), G, AT, A, axis_ch, n_ax,
                 geom.nx, geom.ny, device=P.device)
    return out, up, dn


def rebin_place(P, up, dn, geom: Geometry, axis_ch: int,
                zghost: bool = False):
    """Place pass (with the +-1-cell rolls of the direction buffers
    folded in as neighbor reads): the CUDA kernel for CUDA float32
    tensors, the plain twin for CPU tensors; raises otherwise.
    ``zghost``: the z pass on a slab, ``up`` and ``dn`` with their ghost
    planes (:func:`place_plain`)."""
    if P.device.type == "cpu":
        return place_plain(P, up, dn, geom, axis_ch, zghost)
    if P.device.type != "cuda":
        raise RuntimeError(f"rebin_place: unsupported device {P.device}")
    G, C, AT = P.shape
    A = _mover_cols(AT)
    _check_at(AT)
    if zghost and axis_ch != 2:
        raise ValueError("rebin_place: ghost planes are a z pass's")
    Gb = G + geom.nx * geom.ny if zghost else G
    kernels.check_operand("rebin_place", P, (geom.n_cells, CHANNELS, AT))
    kernels.check_operand("rebin_place up", up, (Gb, CHANNELS, A))
    kernels.check_operand("rebin_place dn", dn, (Gb, CHANNELS, A))
    if not (up.device == dn.device == P.device):
        raise ValueError("rebin_place: tensors on different devices")
    out = torch.empty_like(P)
    kernels.call("rebin_place", P.data_ptr(), up.data_ptr(), dn.data_ptr(),
                 out.data_ptr(), G, AT, A, axis_ch, geom.nx, geom.ny,
                 geom.nz, int(zghost), device=P.device)
    return out


# -- the guard ----------------------------------------------------------------


def _axis_direction_masks(st: BinnedState, geom: Geometry):
    """Per-axis (plus, minus, stay) slot masks, classified exactly as the
    extract kernel does, except that the wrap counts as a one-cell move
    only on PERIODIC axes.  Returns ``(masks, far)``; ``far`` flags
    slots the exchange cannot route."""
    G, K = st.valid.shape
    dev = st.valid.device
    masks = []
    far = torch.zeros((G, K), dtype=torch.bool, device=dev)
    for axis, _grid, _n in _axes(geom):
        home, n = _global_axis(geom, axis, dev)
        home = home[:, None]
        if n == 1:
            z = torch.zeros((G, K), dtype=torch.bool, device=dev)
            masks.append((z, z, torch.ones_like(z)))
            continue
        periodic = geom.bounds[axis] == PERIODIC
        c = torch.clamp(torch.floor(st.r[..., axis]).to(torch.int64),
                        0, n - 1)
        stay = c == home
        plus = c == home + 1
        minus = c == home - 1
        if periodic:
            plus |= (home == n - 1) & (c == 0)
            if n > 2:
                minus |= (home == 0) & (c == n - 1)
        if n == 2:
            minus = torch.zeros_like(plus)  # the kernel routes all as plus
        masks.append((plus, minus, stay))
        far |= ~(stay | plus | minus)
    return masks, far


def far_mover_count(st: BinnedState, geom: Geometry) -> torch.Tensor:
    """Number of live slots whose move exceeds one cell along any axis."""
    total = torch.zeros((), dtype=torch.int64, device=st.valid.device)
    for axis, _grid, _n in _axes(geom):
        home, n = _global_axis(geom, axis, st.valid.device)
        home = home[:, None]
        if n == 1:
            continue
        c = torch.clamp(torch.floor(st.r[..., axis]).to(torch.int64),
                        0, n - 1)
        d = torch.abs(c - home)
        near = d <= 1
        if geom.bounds[axis] == PERIODIC:
            near |= d >= n - 1
        total = total + torch.sum(st.valid & ~near)
    return total


def neighbor_guard_stats(st: BinnedState, geom: Geometry):
    """``(neighbor_ok, moved, n_before)`` as 0-d tensors.

    ``neighbor_ok`` is exact for the dimension-split exchange: movers are
    counted per origin cell into their per-axis direction classes, and
    those [G] count maps are rolled along the pass axes to bound the
    buffer at every stage: leavers <= AT and x counts <= A at the
    origin; occupancy <= AT and y counts <= A after the x pass;
    occupancy <= AT and z counts <= A after the y pass; arrivals <= AT.
    Plus no far movers.  On a slab the counts cross the slab faces
    through the mesh, the slab holds at least 3 planes (the extract
    kernel has no -1 class on 2), and ``neighbor_ok`` is the rank's own:
    the caller reduces it over the ranks."""
    G, K = st.valid.shape
    AT = _buffer_cols(K)
    A = _mover_cols(K)

    masks, far = _axis_direction_masks(st, geom)
    (xp_m, xm_m, xs_m), (yp_m, ym_m, ys_m), (zp_m, zm_m, zs_m) = masks
    routable = st.valid & ~far
    mover = routable & ~(xs_m & ys_m & zs_m)
    moved = torch.sum(mover)
    n_before = torch.sum(st.valid)
    ok = torch.sum(st.valid & far) == 0

    def cnt(mask):
        return torch.sum(mover & mask, dim=1)  # [G]

    shape3 = (geom.nz, geom.ny, geom.nx)

    def roll3(v, gx=0, gy=0, gz=0):
        out = v.reshape(shape3)
        if gx:
            out = torch.roll(out, gx, dims=2)
        if gy:
            out = torch.roll(out, gy, dims=1)
        if gz:
            out = torch.roll(out, gz, dims=0)
        return out.reshape(-1)

    x_cls = ((xp_m, 1), (xm_m, -1), (xs_m, 0))
    y_cls = ((yp_m, 1), (ym_m, -1), (ys_m, 0))

    ok &= torch.max(cnt(torch.ones_like(mover))) <= AT
    ok &= torch.max(cnt(xp_m)) <= A
    ok &= torch.max(cnt(xm_m)) <= A

    occ1 = yp1 = ym1 = 0
    for mx, i in x_cls:
        occ1 = occ1 + roll3(cnt(mx), gx=i)
        yp1 = yp1 + roll3(cnt(mx & yp_m), gx=i)
        ym1 = ym1 + roll3(cnt(mx & ym_m), gx=i)
    ok &= torch.max(occ1) <= AT
    ok &= torch.max(yp1) <= A
    ok &= torch.max(ym1) <= A

    occ2 = zp2 = zm2 = 0
    for mx, i in x_cls:
        for my, j in y_cls:
            occ2 = occ2 + roll3(cnt(mx & my), gx=i, gy=j)
            zp2 = zp2 + roll3(cnt(mx & my & zp_m), gx=i, gy=j)
            zm2 = zm2 + roll3(cnt(mx & my & zm_m), gx=i, gy=j)
    ok &= torch.max(occ2) <= AT
    ok &= torch.max(zp2) <= A
    ok &= torch.max(zm2) <= A

    if mesh_of(geom) is None:
        from_dn, from_up = roll3(zp2, gz=1), roll3(zm2, gz=-1)
    else:
        ok &= geom.nz >= 3
        zz = mesh_of(geom).halo_pad(
            torch.stack([zp2, zm2]).reshape((2,) + shape3), 1, 1, dim=1)
        from_dn = zz[0].narrow(0, 0, geom.nz).reshape(-1)
        from_up = zz[1].narrow(0, 2, geom.nz).reshape(-1)
    occ3 = from_dn + from_up + (occ2 - zp2 - zm2)
    ok &= torch.max(occ3) <= AT
    return ok, moved, n_before


# -- the exchange -------------------------------------------------------------


def partition_movers(st: BinnedState, geom: Geometry):
    """Steps 1-2 of the exchange: the per-row partition sort
    [stayers | dead | movers], stable in the slot index (one sort on the
    combined key key*K + col), and the mover buffer [G, 8, AT] sliced
    from the row tails.  Returns ``(planes, stay, buf, mover)``: the six
    sorted payload planes [G, K], the stayer mask of the sorted rows, the
    buffer, and the mover mask of the input rows."""
    G, K = st.valid.shape
    AT = _buffer_cols(K)
    ids = state_cell_ids(st, geom)
    kcol = torch.arange(K, dtype=torch.int64, device=st.r.device)[None, :]
    home_flat = torch.arange(G, dtype=torch.int64,
                             device=st.r.device)[:, None]
    mover = st.valid & (ids != home_flat)
    key = torch.where(mover, 2, torch.where(st.valid, 0, 1))
    _, perm = torch.sort(key * K + kcol, dim=1)
    key_s = torch.gather(key, 1, perm)
    planes = [torch.gather(st.r[..., a], 1, perm) for a in range(3)] + \
             [torch.gather(st.p[..., a], 1, perm) for a in range(3)]
    bufv = (key_s[:, K - AT:] == 2).to(st.r.dtype)
    buf = torch.stack(
        [pln[:, K - AT:] * bufv for pln in planes]
        + [bufv, torch.zeros_like(bufv)], dim=1).contiguous()
    return planes, key_s == 0, buf, mover


def slab_z_proxy(buf, geom: Geometry):
    """The z pass's buffer on a slab: channel 7 takes the z positions,
    channel 2 the slab plane each live lane goes to (+0.5), wrapped
    around the slab's planes."""
    z = buf[:, 2, :]
    live = buf[:, _VALID_CH, :] > 0.5
    home, n = _global_axis(geom, 2, buf.device)
    cz = torch.clamp(torch.floor(z).to(torch.int64), 0, n - 1)
    dz = cz - home[:, None]
    dz = torch.where(dz > n // 2, dz - n,
                     torch.where(dz < -(n // 2), dz + n, dz))
    home = home[:, None] - z0_of(geom)
    proxy = torch.remainder(home + dz, geom.nz).to(buf.dtype) + 0.5
    out = buf.clone()
    out[:, 7, :] = z
    out[:, 2, :] = torch.where(live, proxy, torch.zeros_like(z))
    return out


def slab_z_ghosts(up, dn, geom: Geometry):
    """The z pass's up buffer with a ghost plane below the slab (the down
    rank's top-plane up movers) and its down buffer with one above (the
    up rank's bottom-plane down movers): one exchange."""
    plane = geom.nx * geom.ny
    G = up.shape[0]
    to_up, to_dn = up[G - plane:], dn[:plane]
    from_dn, from_up = mesh_of(geom).exchange(to_up, to_dn, "rebin_z")
    if from_dn is None:
        from_dn = torch.zeros_like(to_up)
    if from_up is None:
        from_up = torch.zeros_like(to_dn)
    return torch.cat([from_dn, up]), torch.cat([dn, from_up])


def _slab_z_pass(buf, geom: Geometry, plain: bool):
    buf = slab_z_proxy(buf, geom)
    extract = extract_plain if plain else rebin_extract
    place = place_plain if plain else rebin_place
    buf, up, dn = extract(buf, geom, 2)
    up, dn = slab_z_ghosts(up, dn, geom)
    buf = place(buf, up, dn, geom, 2, True)
    out = buf.clone()
    out[:, 2, :] = buf[:, 7, :]
    out[:, 7, :] = 0.0
    return out


def rebin_neighbor(st: BinnedState, geom: Geometry, *, stats=None,
                   plain: bool = False):
    """Dimension-split neighbor migration; returns ``(state, load)`` with
    ``load = [max_per_cell, dropped, moved]``, like
    ``binning._rebin_global``.  Requires every live slot to move at most
    one cell per axis (``binning._rebin_neighbor_guarded`` checks).
    ``stats`` is an optional precomputed ``(moved, n_before)``.
    ``plain=True`` runs the kernels' twins whatever the device: the
    reference the kernels are held against on the card."""
    G, K = st.valid.shape
    dtype, dev = st.r.dtype, st.r.device
    AT = _buffer_cols(K)
    planes, stay, buf, mover = partition_movers(st, geom)
    n_stay = torch.sum(stay, dim=1)
    if stats is None:
        moved, n_before = torch.sum(mover), torch.sum(st.valid)
    else:
        moved, n_before = stats

    # 3. Dimension-split exchange on the buffer only.
    for axis_ch, _grid_axis, n_ax in _axes(geom):
        if n_ax == 1:
            continue
        if axis_ch == 2 and mesh_of(geom) is not None:
            buf = _slab_z_pass(buf, geom, plain)
        elif plain:
            buf, up, dn = extract_plain(buf, geom, axis_ch)
            buf = place_plain(buf, up, dn, geom, axis_ch)
        else:
            buf, up, dn = rebin_extract(buf, geom, axis_ch)
            buf = rebin_place(buf, up, dn, geom, axis_ch)

    # 4. Static tail merge: arrival q -> column K-1-q.
    arr_ok = buf[:, _VALID_CH, :] > 0.5
    qs = torch.arange(AT, dtype=torch.int64, device=dev)[None, :]
    ok = arr_ok & ((K - 1 - qs) >= n_stay[:, None])
    okr = torch.flip(ok, dims=(1,))
    center = _cell_centers(geom, dtype, dev)

    r_stay = torch.stack(planes[0:3], dim=-1)
    p_stay = torch.stack(planes[3:6], dim=-1)
    r_stay = torch.where(stay[..., None], r_stay, center)
    p_stay = torch.where(stay[..., None], p_stay, torch.zeros_like(p_stay))
    arr_r = torch.flip(buf[:, 0:3, :].transpose(1, 2), dims=(1,))
    arr_p = torch.flip(buf[:, 3:6, :].transpose(1, 2), dims=(1,))
    r = torch.cat(
        [r_stay[:, : K - AT],
         torch.where(okr[..., None], arr_r, r_stay[:, K - AT:])], dim=1)
    p = torch.cat(
        [p_stay[:, : K - AT],
         torch.where(okr[..., None], arr_p, p_stay[:, K - AT:])], dim=1)
    valid = torch.cat([stay[:, : K - AT], stay[:, K - AT:] | okr], dim=1)

    counts = torch.sum(valid, dim=1)
    n_after = torch.sum(counts)
    load = torch.stack([torch.max(counts), n_before - n_after, moved])
    return BinnedState(r=r, p=p, valid=valid), load
