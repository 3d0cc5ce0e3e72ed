"""K2 / K3: ESDF relaxation sweeps (CUDA kernels + plain twins).

Counterparts of the JAX package's ``ops/pallas/esdf_sweep.py``:

- ``esdf_sweep`` (K2, ``esdf_sweep_pallas``): one Jacobi sweep over the
  halo-assembled sweep layout ``(N, W, W*W)`` = ``[j | i*W + k]``,
  W = V + 2, with an 8-row slab activity gate;
- ``esdf_sweep_loop`` (K3, ``esdf_sweep_loop_pallas``): the whole sweep
  loop with in-place halo-shell exchange, slab gates and a convergence
  exit, returning ``[sweeps_run, changed_at_exit, computed_slabs,
  shell_rows]``.

Both kernels are in ``csrc/esdf_sweep.cu``. ``esdf_sweep_ref`` and
``esdf_sweep_loop_ref`` are plain PyTorch versions with the same
signatures; the wrappers take them only for CPU tensors. The update side
mask must be zero on halo positions (interior-only), as in the JAX
package. Up to ``MAX_V`` a row lives in the CTA's shared memory; up to
``MAX_CLUSTER_V`` in the shared memory of a thread-block cluster of
``cluster_ctas(V)`` CTAs, ``row_cluster_smem_bytes(V, C)`` each; a larger V
runs the kernels' device-memory build, whose row scratch (one
``row_scratch_bytes(V)`` slice per CTA) the wrappers allocate. Which build
runs follows from V alone (``kernel_build``); the wrappers count their
launches by build in ``site_launches``.

The wrappers are capture-safe: their host work (shape checks, the scratch
size, the SM count) depends on shapes only, their outputs and scratch come
from the allocator (a graph's pool under capture), the one-time kernel
attributes are set on the first, eager call, and stream capture takes K3's
cooperative launch as it is, with or without a cluster dimension; the
launch counters count each replay of a captured graph (``build.count``),
with each launch's rows and field cells (rows x (V + 2)^3) as ``k2/*`` and
``k3/*`` counters of ``utils/profiling``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from taichislam_tpu_torch.ops.kernels import build

BIG = 1e9
# participation encoding: enc = TSDF where observed-and-active, ENC_BIG
# otherwise (far outside any TSDF value)
ENC_BIG = 1e6
R = 8  # rows per activity slab
# the largest V whose row the kernels keep in shared memory (kMaxV in
# csrc/esdf_sweep.cu): a row's shared memory (row_smem_bytes) must fit in
# what a CTA may take on the H100; a larger V keeps it in device memory
MAX_V = 20
MAX_SMEM = 227 * 1024
# the largest V whose row the kernels keep in the shared memory of a
# portable thread-block cluster of at most MAX_CLUSTER CTAs (kMaxClusterV
# and kMaxCluster in csrc/esdf_sweep.cu); a larger V keeps it in device
# memory
MAX_CLUSTER_V = 40
MAX_CLUSTER = 8
# the V compiled with constant shapes (kFastV, kSmallV; kClusterV24,
# kClusterV32)
FAST_V, SMALL_V = 16, 8
CLUSTER_FAST_V = (24, 32)
# CTAs per SM the kernels' registers are budgeted for (kMinBlocks): the
# device-memory build runs that many per SM at most
CTAS_PER_SM = 2


def _f32(x: float) -> float:
    """Round a constant to f32 once, so every comparison and arithmetic
    step sees the value the JAX package's ``jnp.float32`` constant has."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def _consts(v1, gamma, eps, max_ray):
    """(v1, v2, v3, gamma, eps, max_ray) rounded to f32 once per set."""
    return (_f32(v1), _f32(np.sqrt(2.0) * v1), _f32(np.sqrt(3.0) * v1),
            _f32(gamma), _f32(eps), _f32(max_ray))


def _lsh(x, s, fill):
    """out[..., l] = x[..., l + s] within each row, vacated lanes = fill."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype,
                     device=x.device)
    if s > 0:
        return torch.cat([x[..., s:], pad], dim=-1)
    return torch.cat([pad, x[..., :s]], dim=-1)


def _jsh(x, s, fill):
    """out[:, j] = x[:, j + s], vacated rows = fill."""
    if s == 0:
        return x
    pad = torch.full((x.shape[0], abs(s), x.shape[2]), fill, dtype=x.dtype,
                     device=x.device)
    if s > 0:
        return torch.cat([x[:, s:, :], pad], dim=1)
    return torch.cat([pad, x[:, :s, :]], dim=1)


def sweep_math(h, enc, side, *, W: int, v1: float, gamma: float, eps: float,
               max_ray: float, with_scans: bool):
    """One relaxation-sweep update of rows ``h`` (N, W, W*W) with halos
    assembled; ``side`` is the +1/-1/0 update side (any dtype). Plain
    PyTorch form of the Pallas ``_sweep_math``."""
    v1f, v2f, v3f, gammaf, epsf, mrf = _consts(v1, gamma, eps, max_ray)
    obs = enc < ENC_BIG * 0.5
    tsdf = torch.where(obs, enc, 0.0)
    fixed = (tsdf.abs() < gammaf) & obs
    psrc = torch.where(tsdf >= gammaf, obs, fixed)
    nsrc = torch.where(tsdf <= -gammaf, obs, fixed)

    def extrema(x, op, fill):
        ai = op(_lsh(x, W, fill), _lsh(x, -W, fill))
        aj = op(_jsh(x, 1, fill), _jsh(x, -1, fill))
        ak = op(_lsh(x, 1, fill), _lsh(x, -1, fill))
        faces = op(op(ai, aj), ak)
        eij = op(_jsh(ai, 1, fill), _jsh(ai, -1, fill))
        eik = op(_lsh(ai, 1, fill), _lsh(ai, -1, fill))
        ejk = op(_lsh(aj, 1, fill), _lsh(aj, -1, fill))
        edges = op(op(eij, eik), ejk)
        corners = op(_lsh(eij, 1, fill), _lsh(eij, -1, fill))
        return faces, edges, corners

    lo = torch.where(psrc, h, BIG)
    hi = torch.where(nsrc, h, -BIG)
    fl, el, cl = extrema(lo, torch.minimum, BIG)
    fh, eh, ch = extrema(hi, torch.maximum, -BIG)
    cand_lo = torch.minimum(torch.minimum(fl + v1f, el + v2f), cl + v3f)
    cand_hi = torch.maximum(torch.maximum(fh - v1f, eh - v2f), ch - v3f)

    if with_scans:
        n_steps = max(1, int(np.ceil(np.log2(W))))
        lane = torch.arange(W * W, device=h.device)
        k_pos = (lane % W).float().view(1, 1, -1)
        i_pos = (lane // W).float().view(1, 1, -1)
        j_pos = torch.arange(W, device=h.device).float().view(1, W, 1)

        def dbl(w, brk, shift_fn):
            """Inclusive segmented min by Hillis-Steele doubling."""
            m, b = w, brk
            s = 1
            for _ in range(n_steps):
                m = torch.minimum(m, torch.where(b, BIG, shift_fn(m, s, BIG)))
                b = b | shift_fn(b, s, True)
                s *= 2
            return m

        def scans(x, brk):
            out = torch.full_like(x, BIG)
            for pos, step, lane_axis in ((k_pos, 1, True), (i_pos, W, True),
                                         (j_pos, 1, False)):
                if lane_axis:
                    def sh_f(xx, s, f, step=step):
                        return _lsh(xx, -s * step, f)

                    def sh_b(xx, s, f, step=step):
                        return _lsh(xx, s * step, f)
                else:
                    def sh_f(xx, s, f):
                        return _jsh(xx, -s, f)

                    def sh_b(xx, s, f):
                        return _jsh(xx, s, f)
                pv = pos * v1f
                brk_f = brk | (pos == 0.0)
                brk_b = brk | (pos == float(W - 1))
                incl_f = dbl(x - pv, brk_f, sh_f) + pv
                incl_b = dbl(x + pv, brk_b, sh_b) - pv
                out = torch.minimum(out, torch.minimum(
                    sh_f(incl_f, 1, BIG) + v1f, sh_b(incl_b, 1, BIG) + v1f))
            return out

        cand_lo = torch.minimum(cand_lo, scans(lo, ~psrc | fixed))
        cand_hi = torch.maximum(cand_hi, -scans(-hi, ~nsrc | fixed))

    new = torch.where(cand_lo <= h + epsf, torch.minimum(h, cand_lo),
                      torch.clamp(cand_lo, max=mrf))
    new = torch.where(side > 0, new, h)
    new_n = torch.where(cand_hi >= h - epsf, torch.maximum(h, cand_hi),
                        torch.clamp(cand_hi, min=-mrf))
    return torch.where(side < 0, new_n, new)


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


def row_smem_bytes(V: int) -> int:
    """Dynamic shared memory of one row in K2 and K3 (``smem_bytes`` in
    csrc/esdf_sweep.cu): the field, the (lo, -hi) pairs, two scan-candidate
    arrays of V^2 lines at pitch V + 1 (plus 16 floats each) and a flag
    byte per voxel, each part 16-byte aligned."""
    W3 = (V + 2) ** 3
    return (_a16(W3 * 4) + _a16(W3 * 8) +
            _a16(2 * (V * V * (V + 1) + 16) * 4) + W3)


def row_scratch_bytes(V: int) -> int:
    """Device-memory scratch of one CTA in the V > MAX_CLUSTER_V build
    (``scratch_bytes`` in csrc/esdf_sweep.cu): the row's shared-memory
    layout rounded up to 16 bytes."""
    return _a16(row_smem_bytes(V))


def cluster_planes(V: int, C: int) -> int:
    """Interior planes each CTA of a C-CTA cluster owns (``cl_planes``;
    the last CTA may own fewer)."""
    return -(-V // C)


def row_cluster_smem_bytes(V: int, C: int) -> int:
    """Dynamic shared memory of one CTA of a row's C-CTA cluster
    (``cl_smem_bytes`` in csrc/esdf_sweep.cu): the (lo, -hi) pairs of its
    P owned planes and the two beside them, the owned planes' field and
    scan candidates (pitch V + 1), the columns' float4 j-line carries and
    their restart bytes, and the flags of the P + 2 planes."""
    W2, P, VV = (V + 2) ** 2, cluster_planes(V, C), V * V
    return (_a16((P + 2) * W2 * 8) + _a16(P * W2 * 4) +
            _a16(P * V * (V + 1) * 4) + VV * 16 + _a16(VV) + (P + 2) * W2)


def cluster_ctas(V: int) -> int:
    """CTAs of a row's cluster (``cluster_ctas``): the fewest, from 2,
    whose share fits in MAX_SMEM; 0 when no portable cluster holds it."""
    return next((C for C in range(2, MAX_CLUSTER + 1)
                 if row_cluster_smem_bytes(V, C) <= MAX_SMEM), 0)


def kernel_build(kernel: str, V: int) -> str:
    """The CUDA kernel that a launch of ``kernel`` ("k2" or "k3") at V
    runs, as csrc/esdf_sweep.cu's launch functions choose it."""
    base = "k2_kernel" if kernel == "k2" else "k3_loop_kernel"
    if V > MAX_CLUSTER_V:
        return "k2_kernel_gm" if kernel == "k2" else "k3_loop_kernel<-1>"
    if V > MAX_V:
        return f"{base}_cl<{V if V in CLUSTER_FAST_V else 0}>"
    return f"{base}<{V if V in (FAST_V, SMALL_V) else 0}>"


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(N, V, dev):
    """(scratch, CTAs) of a launch: none up to MAX_CLUSTER_V; past it a
    ``row_scratch_bytes(V)`` slice for each CTA, at most CTAS_PER_SM per SM
    and one per row."""
    if V <= MAX_CLUSTER_V:
        return None, 0
    ctas = min(N, CTAS_PER_SM * _sm_count(dev.index if dev.index is not None
                                          else torch.cuda.current_device()))
    return torch.empty((ctas * row_scratch_bytes(V),), dtype=torch.uint8,
                       device=dev), ctas


def _check_shape(N, V):
    if V < 1:
        raise ValueError(f"V = {V}: the kernels take V >= 1")
    if N % R:
        raise ValueError(f"rows must be a multiple of {R}, got {N}")


def _check_field(name, t, N, W, dtype, device):
    if t.shape != (N, W, W * W) or t.dtype != dtype or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} ({N}, {W}, "
                         f"{W * W}) on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# K2: one sweep
# ---------------------------------------------------------------------------

def esdf_sweep_ref(esdf_h, enc_h, side_h, slab_act=None, *, V: int,
                   v1: float, gamma: float, eps: float, max_ray: float,
                   with_scans: bool = True):
    """Plain PyTorch version of :func:`esdf_sweep`."""
    new = sweep_math(esdf_h, enc_h, side_h, W=V + 2, v1=v1, gamma=gamma,
                     eps=eps, max_ray=max_ray, with_scans=with_scans)
    if slab_act is None:
        return new
    rows = slab_act.repeat_interleave(R) != 0
    return torch.where(rows[:, None, None], new, esdf_h)


def esdf_sweep(esdf_h, enc_h, side_h, slab_act=None, *, V: int, v1: float,
               gamma: float, eps: float, max_ray: float,
               with_scans: bool = True):
    """One fused relaxation sweep over the (N, W, W*W) sweep-layout field
    (halos assembled; N a multiple of 8). ``enc_h`` is the encoded
    TSDF/participation channel, ``side_h`` the interior-only int8 update
    side, ``slab_act`` an (N/8,) int32 gate (None = all slabs). Returns the
    updated field; inactive slabs and halo positions pass through."""
    if esdf_h.device.type == "cpu":
        return esdf_sweep_ref(esdf_h, enc_h, side_h, slab_act, V=V, v1=v1,
                              gamma=gamma, eps=eps, max_ray=max_ray,
                              with_scans=with_scans)
    if esdf_h.device.type != "cuda":
        raise ValueError(f"unsupported device {esdf_h.device}")
    N, W, dev = esdf_h.shape[0], V + 2, esdf_h.device
    _check_shape(N, V)
    _check_field("esdf_h", esdf_h, N, W, torch.float32, dev)
    _check_field("enc_h", enc_h, N, W, torch.float32, dev)
    _check_field("side_h", side_h, N, W, torch.int8, dev)
    act = 0   # a null gate: every slab runs
    if slab_act is not None:
        if slab_act.shape != (N // R,) or slab_act.dtype != torch.int32 or \
                slab_act.device != dev:
            raise ValueError("slab_act: want (N/8,) int32 on the field's "
                             "device")
        if not slab_act.is_contiguous():
            slab_act = slab_act.contiguous()
        act = slab_act.data_ptr()
    out = torch.empty_like(esdf_h)
    scratch, ctas = _scratch(N, V, dev)
    v1f, v2f, v3f, gf, ef, mf = _consts(v1, gamma, eps, max_ray)
    err = build.library().esdf_sweep_launch(
        esdf_h.data_ptr(), enc_h.data_ptr(), side_h.data_ptr(), act,
        out.data_ptr(), N, V, v1f, v2f, v3f, gf, ef, mf, int(with_scans),
        0 if scratch is None else scratch.data_ptr(), ctas,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "esdf_sweep_launch")
    build.count(esdf_sweep, kernel_build("k2", V),
                {"k2/launches": 1, "k2/rows": N, "k2/cells": N * W ** 3})
    return out


esdf_sweep.launches = 0
esdf_sweep.site_launches = {}   # kernel build -> launches


# ---------------------------------------------------------------------------
# K3: the sweep loop
# ---------------------------------------------------------------------------

_FACE_COLS = (4, 22, 10, 16, 12, 14)  # i-, i+, j-, j+, k-, k+ in nsl27


def loop_gates_ref(nsl27, upd_rows, slabchg=None):
    """The loop's slab gates in sparse form: (acts, shellact), (N/8,) bool.

    acts[m] is the OR, over the updatable rows of slab m and their 27
    neighbours (the row itself included), of slabchg[slab(nbr)]; with
    ``slabchg`` None every slab counts as changed, which gives the first
    sweep's gates (the slabs with an updatable row). shellact marks the
    slabs of the 27 neighbours of every row of an active slab. Equal to the
    JAX package's dense products over adj / adjS."""
    N = nsl27.shape[1]
    nbr_slab = nsl27.long() // R                               # (27, N)
    hit = torch.ones_like(nbr_slab, dtype=torch.bool) if slabchg is None \
        else slabchg.bool()[nbr_slab]
    acts = (hit & (upd_rows != 0)[None, :]).any(dim=0).view(-1, R).any(dim=1)
    src = acts.repeat_interleave(R)[None, :].expand(27, N)
    shellact = torch.zeros_like(acts)
    shellact[nbr_slab[src]] = True
    return acts, shellact


def _scan_pred(s, scan_sweeps, scan_period):
    return s < scan_sweeps or (scan_period > 0 and s % scan_period == 0)


def esdf_sweep_loop_ref(esdf_h, enc_hh, nsl27, upd_rows, *, V: int,
                        v1: float, gamma: float, eps: float, eps_conv: float,
                        max_ray: float, max_sweeps: int, scan_sweeps: int = 1,
                        scan_period: int = 0):
    """Plain PyTorch version of :func:`esdf_sweep_loop`."""
    N, W = esdf_h.shape[0], V + 2
    dev = esdf_h.device
    acts, shellact = loop_gates_ref(nsl27, upd_rows)
    nsl = nsl27[list(_FACE_COLS)].long()
    upd = upd_rows != 0
    fld = esdf_h.clone()
    f4 = fld.view(N, W, W, W)  # (row, j, i, k)

    # interior update side, derived as the loop kernel derives it
    obs = enc_hh < ENC_BIG * 0.5
    tsdf = torch.where(obs, enc_hh, 0.0)
    fixed = (tsdf.abs() < _f32(gamma)) & obs
    c = torch.arange(W, device=dev)
    inter1 = (c >= 1) & (c <= V)
    inter = (inter1.view(W, 1, 1) & inter1.view(1, W, 1) &
             inter1.view(1, 1, W)).reshape(1, W, W * W)
    sgn = torch.where(tsdf >= 0.0, 1.0, -1.0)
    side = torch.where(obs & ~fixed & inter & upd[:, None, None], sgn, 0.0)

    sweeps = comp = shells = 0
    quiet = False
    for s in range(max_sweeps):
        if quiet:
            break
        rows_sh = shellact.repeat_interleave(R)
        shells += int(rows_sh.sum())
        m = rows_sh[:, None, None]
        for (a, b), sel in (((0, 1), lambda t, p: t[:, :, p, :]),
                            ((2, 3), lambda t, p: t[:, p, :, :]),
                            ((4, 5), lambda t, p: t[:, :, :, p])):
            lo_src = sel(f4, V)[nsl[a]]
            hi_src = sel(f4, 1)[nsl[b]]
            sel(f4, 0).copy_(torch.where(m, lo_src, sel(f4, 0)))
            sel(f4, V + 1).copy_(torch.where(m, hi_src, sel(f4, V + 1)))
        rows_act = acts.repeat_interleave(R) & upd
        comp += int(acts.sum())
        new = sweep_math(fld, enc_hh, side, W=W, v1=v1, gamma=gamma, eps=eps,
                         max_ray=max_ray,
                         with_scans=_scan_pred(s, scan_sweeps, scan_period))
        new = torch.where(rows_act[:, None, None], new, fld)
        rowchg = ((new - fld).abs() > _f32(eps_conv)).any(dim=2).any(dim=1)
        slabchg = rowchg.view(-1, R).any(dim=1)
        fld.copy_(new)
        sweeps += 1
        quiet = not bool(slabchg.any())
        acts, shellact = loop_gates_ref(nsl27, upd_rows, slabchg)
    stats = torch.tensor([sweeps, 0 if quiet else 1, comp, shells],
                         dtype=torch.int32, device=dev)
    return fld, stats


def esdf_sweep_loop(esdf_h, enc_hh, nsl27, upd_rows, *, V: int, v1: float,
                    gamma: float, eps: float, eps_conv: float,
                    max_ray: float, max_sweeps: int, scan_sweeps: int = 1,
                    scan_period: int = 0):
    """Run up to ``max_sweeps`` relaxation sweeps, halo exchange included.
    ``esdf_h`` needs valid interiors only; ``enc_hh`` is the halo-assembled
    encoded channel; ``nsl27`` the (27, N) int32 compact neighbour table
    (garbage row for missing neighbours, whose enc must be ENC_BIG);
    ``upd_rows`` the (N,) updatable-row mask (on the card both contiguous
    int32). Returns (field, stats) with
    stats = [sweeps_run, changed_at_exit, computed_slabs, shell_rows]
    int32. On the card the whole loop is one cooperative launch that leaves
    when a sweep changes nothing."""
    if esdf_h.device.type == "cpu":
        return esdf_sweep_loop_ref(
            esdf_h, enc_hh, nsl27, upd_rows, V=V, v1=v1, gamma=gamma,
            eps=eps, eps_conv=eps_conv, max_ray=max_ray,
            max_sweeps=max_sweeps, scan_sweeps=scan_sweeps,
            scan_period=scan_period)
    if esdf_h.device.type != "cuda":
        raise ValueError(f"unsupported device {esdf_h.device}")
    N, W, dev = esdf_h.shape[0], V + 2, esdf_h.device
    _check_shape(N, V)
    _check_field("esdf_h", esdf_h, N, W, torch.float32, dev)
    _check_field("enc_hh", enc_hh, N, W, torch.float32, dev)
    if nsl27.shape != (27, N) or nsl27.device != dev or \
            upd_rows.shape != (N,) or upd_rows.device != dev:
        raise ValueError("nsl27 / upd_rows: want (27, N) and (N,) on the "
                         "field's device")
    i32 = torch.int32
    if nsl27.dtype != i32 or upd_rows.dtype != i32 or \
            not (nsl27.is_contiguous() and upd_rows.is_contiguous()):
        raise ValueError("nsl27 / upd_rows: want contiguous int32")
    lib = build.library()
    fld = torch.empty_like(esdf_h)
    ws = torch.empty((5 * (N // R) + 2,), dtype=i32, device=dev)
    stats = torch.empty((4,), dtype=i32, device=dev)
    scratch, ctas = _scratch(N, V, dev)
    v1f, v2f, v3f, gf, ef, mf = _consts(v1, gamma, eps, max_ray)
    err = lib.esdf_loop_launch(
        esdf_h.data_ptr(), fld.data_ptr(), enc_hh.data_ptr(),
        nsl27.data_ptr(), upd_rows.data_ptr(), ws.data_ptr(),
        stats.data_ptr(), N, V, v1f, v2f, v3f, gf, ef, mf, _f32(eps_conv),
        max_sweeps, scan_sweeps, scan_period,
        0 if scratch is None else scratch.data_ptr(), ctas,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "esdf_loop_launch")
    build.count(esdf_sweep_loop, kernel_build("k3", V),
                {"k3/launches": 1, "k3/rows": N, "k3/cells": N * W ** 3})
    return fld, stats


esdf_sweep_loop.launches = 0
esdf_sweep_loop.site_launches = {}   # kernel build -> launches
