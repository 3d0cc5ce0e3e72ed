"""Block-mode ESDF: the PyTorch port against the JAX package.

JAX runs its fused Pallas sweep in interpret mode with the loop kernel off
(``pallas_esdf="on"``, ``esdf_loop_kernel="off"``): the per-sweep path that
tests/test_esdf.py proves equal to the loop kernel. The port runs its K3
twin whenever the budget is >= 2 and its K2 twin otherwise. Sweep counts,
changed-block bitmaps, fixed flags and overflow are exact; the field agrees
to 1e-6 on participating voxels (same schedule and math; ~1 ulp where
XLA contracts a multiply-add differently).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import esdf as je  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu.ops.pallas.esdf_sweep import esdf_sweep_pallas  # noqa: E402,E501
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.ops.kernels import esdf_sweep as tk  # noqa: E402

KW = dict(map_scale=(6.4, 6.4), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
          max_bins=8192, max_submap_num=8, esdf_raise_slack_voxels=0.0,
          esdf_seed_eps_voxels=0.0)
JCFG = JConfig(pallas_accum="on", pallas_esdf="on", esdf_loop_kernel="off",
               **KW)
TCFG = TConfig(**KW)
# 24-voxel blocks: rows past the largest the kernels keep in one CTA's
# shared memory (their cluster build on the card)
KW24 = dict(KW, num_voxel_per_blk_axis=24, max_blocks=64)
JCFG24 = JConfig(pallas_accum="on", pallas_esdf="on",
                 esdf_loop_kernel="off", **KW24)
TCFG24 = TConfig(**KW24)
K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
CAP = 64
SHAPE = (KW["max_blocks"] + 1, 8 ** 3)


def _integrate(depth, cfg=JCFG):
    st = jt.make_tsdf_state(cfg)
    st, stats = jt.integrate_depth(cfg, st, jnp.asarray(depth),
                                   jnp.zeros((1, 1, 3), jnp.uint8),
                                   jnp.eye(3), jnp.zeros(3), jnp.asarray(K),
                                   jnp.asarray(K), jnp.int32(0))
    return st, stats


@pytest.fixture(scope="module")
def wall():
    """A flat wall 1 m ahead (the scene of tests/test_esdf.py)."""
    return _integrate(np.full((48, 64), 1000, np.uint16))


def _slope_depth():
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    return (1000 + 4.0 * ii + 2.0 * jj).astype(np.uint16)


@pytest.fixture(scope="module")
def slope():
    return _integrate(_slope_depth())


@pytest.fixture(scope="module")
def slope24():
    """The slope on a map of 24-voxel blocks."""
    return _integrate(_slope_depth(), JCFG24)


def _zeros(shape=SHAPE):
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.int8))


def _compare_update(cfg_j, cfg_t, budget, jstate, e0, f0, **kw):
    """Run both updates from the same state; assert the exact parts and
    the 1e-6 field bound; return the JAX outputs."""
    jkw = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    want = je.esdf_update(cfg_j, budget, CAP, jstate, jnp.asarray(e0),
                          jnp.asarray(f0), jnp.int32(0), **jkw)
    tkw = {k: (None if v is None else torch.from_numpy(np.array(v)))
           for k, v in kw.items()}
    got = te.esdf_update(cfg_t, budget, CAP,
                         bridge.grid_state_from_numpy(jstate, device="cpu"),
                         torch.from_numpy(np.array(e0)),
                         torch.from_numpy(np.array(f0)), 0, **tkw)
    we, wf, wp, ws, wc, wo = (np.asarray(a) for a in want)
    ge, gf, gp, gs, gc, go = (a.numpy() for a in got)
    assert int(ws) == int(gs), (int(ws), int(gs))
    assert int(wo) == int(go)
    np.testing.assert_array_equal(wp, gp)
    np.testing.assert_array_equal(wf, gf)
    np.testing.assert_array_equal(wc, gc)
    err = np.abs(np.where(wp, we - ge, 0.0)).max()
    assert err <= 1e-6, f"field max abs err {err}"
    return we, wf, wp, int(ws), wc


@pytest.mark.parametrize("budget,V", [(2, 8), (6, 8), (2, 24)],
                         ids=["2", "6", "V24-2"])
def test_loop_path_matches_jax_per_sweep(request, budget, V):
    """The K3 twin against JAX's per-sweep Pallas path; at V = 24 past
    the rows one CTA holds (the kernels' cluster build on the card)."""
    state = request.getfixturevalue("slope" if V == 8 else "slope24")[0]
    cj, ct = (JCFG, TCFG) if V == 8 else (JCFG24, TCFG24)
    _, _, part, sweeps, _ = _compare_update(
        cj, ct, budget, state, *_zeros((cj.max_blocks + 1, V ** 3)))
    assert part.sum() > 100 and sweeps == budget


@pytest.mark.parametrize("budget", [2, 6])
def test_loop_path_raise_reactivation_matches(wall, budget):
    """Start from the converged field, erase the wall: the raise front
    moves out and slabs go quiet behind it, then re-lowering re-activates
    them inside one update (tests/test_esdf.py:618)."""
    state = wall[0]
    e0, f0, *_ = je.esdf_update(JCFG, 24, CAP, state, *_zeros(),
                                jnp.int32(0))
    tsdf = np.asarray(state.channels["TSDF"], np.float32)
    erase = np.asarray(state.channels["TSDF_observed"] > 0) & (tsdf < 0.15)
    state2 = state._replace(channels={
        **state.channels, "TSDF": jnp.asarray(np.where(erase, 2.0, tsdf))})
    we, *_ = _compare_update(JCFG, TCFG, budget, state2, e0, f0)
    assert (we - np.asarray(e0) > 0.2).sum() > 50   # the raise moved values


@pytest.mark.parametrize("force", [False, True])
def test_per_sweep_path_matches_jax(slope, force):
    """Budget 1, and forced sweeps (no early exit, no gates): the K2 path."""
    budget = 3 if force else 1
    cj = dataclasses.replace(JCFG, esdf_force_sweeps=force)
    ct = dataclasses.replace(TCFG, esdf_force_sweeps=force)
    _compare_update(cj, ct, budget, slope[0], *_zeros())


def test_dirty_mode_with_snapshot_seeds_matches_jax(slope):
    """The per-frame main path: seed gating, then the dirty working set
    with its frozen rim and consume-once snapshot seeds, twice."""
    state, stats = slope
    touched = np.asarray(stats["touched_blocks"])
    seen_t = jnp.zeros(SHAPE, jnp.float32)
    seen_o = jnp.zeros(SHAPE, bool)
    dirty, seen_t, seen_o = je.esdf_seed_dirty(JCFG, state, seen_t, seen_o,
                                               jnp.asarray(touched))
    e, f = _zeros()
    pending = np.zeros(SHAPE[0], bool)
    for _ in range(2):
        d = np.asarray(dirty) | pending
        e, f, _, _, pending = _compare_update(
            JCFG, TCFG, 3, state, e, f, dirty_blocks=d,
            tsdf_src=np.asarray(seen_t), obs_src=np.asarray(seen_o))
        pending = np.asarray(pending)
    assert pending.any()


@pytest.mark.parametrize("cap", [512, 3])
def test_seed_dirty_matches_jax(slope, cap):
    """Gating against perturbed snapshots; cap 3 overflows the touched
    list (rows past the cap are dirty uncompared)."""
    state, stats = slope
    rng = np.random.default_rng(cap)
    tsdf = np.asarray(state.channels["TSDF"], np.float32)
    seen_t = (tsdf + rng.uniform(-0.01, 0.01, tsdf.shape)).astype(np.float32)
    seen_o = np.array(state.channels["TSDF_observed"]) > 0
    touched = np.asarray(stats["touched_blocks"])
    rows = np.nonzero(touched)[0]
    seen_t[rows[:3], 5] += 0.1         # moved past the 0.25-voxel gate
    seen_o[rows[4], 7] ^= True         # an observed flag flipped
    cfg_j = dataclasses.replace(JCFG, esdf_seed_eps_voxels=0.25)
    cfg_t = dataclasses.replace(TCFG, esdf_seed_eps_voxels=0.25)
    want = je.esdf_seed_dirty(cfg_j, state, jnp.asarray(seen_t),
                              jnp.asarray(seen_o), jnp.asarray(touched), cap)
    got = te.esdf_seed_dirty(cfg_t,
                             bridge.grid_state_from_numpy(state, device="cpu"),
                             torch.from_numpy(seen_t.copy()),
                             torch.from_numpy(seen_o.copy()),
                             torch.from_numpy(touched.copy()), cap)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    n_dirty = int(got[0].sum())
    if cap >= touched.sum():
        assert 0 < n_dirty < touched.sum()
    else:   # past the cap every touched row is dirty uncompared
        assert n_dirty == touched.sum()


def test_working_set_helpers_match_jax(slope):
    state = slope[0]
    ps = bridge.grid_state_from_numpy(state, device="cpu")
    spec = JCFG.grid
    nb = int(state.num_blocks)
    rows = np.arange(nb + 3, dtype=np.int32)
    rows[-3:] = SHAPE[0] - 1
    want = np.asarray(je.neighbor_slot_cols(spec, state, jnp.int32(0),
                                            rows=jnp.asarray(rows)))
    got = te.neighbor_slot_cols(TCFG.grid, ps, 0,
                                rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(want, got.numpy())
    bvalid = np.arange(len(rows)) < nb
    w = je.morton_order_rows(jnp.asarray(rows), jnp.asarray(bvalid),
                             jnp.int32(nb // 2), state.block_coords)
    g = te.morton_order_rows(torch.from_numpy(rows), torch.from_numpy(bvalid),
                             torch.tensor(nb // 2), ps.block_coords)
    np.testing.assert_array_equal(np.asarray(w), g.numpy())

    V, n = 8, 12
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((n, V ** 3)).astype(np.float32)
    nsl = rng.integers(0, n, (27, n)).astype(np.int32)
    tiles[-1] = 7.0   # the garbage row holds the fill
    H = je._to_sweep_layout(jnp.asarray(tiles), V, 7.0)
    Ht = te._to_sweep_layout(torch.from_numpy(tiles), V, 7.0)
    np.testing.assert_array_equal(np.asarray(H), Ht.numpy())
    np.testing.assert_array_equal(
        np.asarray(je._assemble_sweep(H, jnp.asarray(nsl), V, 7.0)),
        te._assemble_sweep(Ht, torch.from_numpy(nsl), V).numpy())
    np.testing.assert_array_equal(
        np.asarray(je._from_sweep_layout(H, V)),
        te._from_sweep_layout(Ht, V).numpy())
    np.testing.assert_array_equal(je._shell_mask_np(V),
                                  te._shell_mask(V, torch.device("cpu")))


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("name", ["neighbor_slot_cols", "neighbor_slot_table"])
def test_neighbor_slots_jax_call_form(slope, name, with_rows):
    """Both packages called as ``f(spec, state, active_submap, rows=None)``:
    ``rows=None`` covers every storage slot; the submap id is unused."""
    state = slope[0]
    ps = bridge.grid_state_from_numpy(state, device="cpu")
    rows = np.random.default_rng(5).integers(0, SHAPE[0], 40).astype(
        np.int32)
    jkw = dict(rows=jnp.asarray(rows)) if with_rows else {}
    tkw = dict(rows=torch.from_numpy(rows)) if with_rows else {}
    want = np.asarray(getattr(je, name)(JCFG.grid, state, jnp.int32(3),
                                        **jkw))
    got = getattr(te, name)(TCFG.grid, ps, 3, **tkw).numpy()
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(want, got)
    n = got.shape[-1] if name.endswith("cols") else got.shape[0]
    assert n == (len(rows) if with_rows else SHAPE[0])


def test_assemble_halo_center_none_matches_jax(slope):
    """``center=None``: the interiors are ``tiles`` itself (n == nb)."""
    state = slope[0]
    V = 8
    nsl = je.neighbor_slot_table(JCFG.grid, state, jnp.int32(0))
    tiles = np.random.default_rng(6).standard_normal(
        (SHAPE[0], V, V, V)).astype(np.float32)
    tiles[-1] = 5.0
    want = je.assemble_halo(jnp.asarray(tiles), nsl, V, 5.0)
    got = te.assemble_halo(torch.from_numpy(tiles),
                           torch.from_numpy(np.array(nsl)), V, 5.0)
    assert got.shape == (SHAPE[0], V + 2, V + 2, V + 2)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_esdf_update_jax_positional_form(slope):
    """JAX's positional order (``dirty_blocks, _ablate, tsdf_src,
    obs_src``) on both sides: the port's positional call holds to JAX's
    as ``_compare_update`` does (exact flags, participation, sweeps,
    re-queue; field 1e-6) and to its own keyword call bit for bit; an
    ablation raises."""
    state, stats = slope
    touched = np.asarray(stats["touched_blocks"])
    _, seen_t, seen_o = je.esdf_seed_dirty(
        JCFG, state, jnp.zeros(SHAPE, jnp.float32), jnp.zeros(SHAPE, bool),
        jnp.asarray(touched))
    want = je.esdf_update(JCFG, 3, CAP, state, *_zeros(), jnp.int32(0),
                          jnp.asarray(touched), "", seen_t, seen_o)
    ps = bridge.grid_state_from_numpy(state, device="cpu")
    dirty = torch.from_numpy(touched.copy())
    src = (torch.from_numpy(np.array(seen_t)), torch.from_numpy(
        np.array(seen_o)))

    def zeros():
        return (torch.zeros(SHAPE, dtype=torch.float32),
                torch.zeros(SHAPE, dtype=torch.int8))

    pos = te.esdf_update(TCFG, 3, CAP, ps, *zeros(), 0, dirty, "", *src)
    we, wf, wp, ws, wc, wo = (np.asarray(a) for a in want)
    ge, gf, gp, gs, gc, go = (a.numpy() for a in pos)
    assert int(ws) == int(gs) and int(wo) == int(go)
    np.testing.assert_array_equal(wp, gp)
    np.testing.assert_array_equal(wf, gf)
    np.testing.assert_array_equal(wc, gc)
    err = np.abs(np.where(wp, we - ge, 0.0)).max()
    assert err <= 1e-6, f"field max abs err {err}"
    assert wp.any()
    kw = te.esdf_update(TCFG, 3, CAP, ps, *zeros(), 0, dirty,
                        tsdf_src=src[0], obs_src=src[1])
    for a, b in zip(pos, kw):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        te.esdf_update(TCFG, 3, CAP, ps, *zeros(), 0, dirty, "ws", *src)


@pytest.mark.parametrize("V", [8, 16, 24])
@pytest.mark.parametrize("with_scans", [False, True])
def test_sweep_twin_matches_pallas_kernel(with_scans, V):
    """K2 twin against esdf_sweep_pallas (interpret) on random fields, at a
    small V, at the main path's V = 16 and at V = 24, past the largest row
    the kernels keep in one CTA's shared memory (their cluster build)."""
    N = 16
    W = V + 2
    rng = np.random.default_rng(int(with_scans) + V)
    tsdf = rng.uniform(-0.5, 0.5, (N, W, W * W)).astype(np.float32)
    part = rng.random(tsdf.shape) < 0.85
    enc = np.where(part, tsdf, 1e6).astype(np.float32)
    esdf = (tsdf + rng.uniform(-0.4, 0.4, tsdf.shape)).astype(np.float32)
    c = np.arange(W)
    inter1 = (c >= 1) & (c <= V)
    inter = (inter1[:, None, None] & inter1[None, :, None] &
             inter1[None, None, :]).reshape(1, W, W * W)
    fixed = part & (np.abs(tsdf) < 0.1)
    side = np.where(part & ~fixed & inter, np.where(tsdf >= 0, 1, -1),
                    0).astype(np.int8)
    act = np.array([1, 0], np.int32)
    kw = dict(V=V, v1=0.1, gamma=0.1, eps=0.05, max_ray=2.0,
              with_scans=with_scans)
    want = np.asarray(esdf_sweep_pallas(
        jnp.asarray(esdf), jnp.asarray(enc), jnp.asarray(side),
        jnp.asarray(act), interpret=True, **kw))
    got = tk.esdf_sweep(torch.from_numpy(esdf), torch.from_numpy(enc),
                        torch.from_numpy(side), torch.from_numpy(act), **kw)
    assert np.abs(want - got.numpy()).max() <= 1e-6
    assert np.array_equal(want[8:], esdf[8:])   # the idle slab passed
    assert not np.array_equal(want[:8], esdf[:8])


def _dense_gates(nsl27, upd_rows, slabchg):
    """The JAX package's gates (esdf_sweep_loop_pallas): dense slab
    adjacencies adj (updatable rows) and adjS (all rows), then
    acts = slabchg . adj^T and shellact = acts . adjS; with slabchg None the
    first sweep's acts0 = any(adj) and its dilation."""
    N = nsl27.shape[1]
    NSLAB = N // 8
    slab_of = np.arange(N) // 8
    nbr_slab = slab_of[nsl27]                                  # (27, N)
    adj = np.zeros((NSLAB, NSLAB), bool)
    adjS = np.zeros((NSLAB, NSLAB), bool)
    for c in range(27):
        adjS[slab_of, nbr_slab[c]] = True
        u = upd_rows != 0
        adj[slab_of[u], nbr_slab[c][u]] = True
    acts = adj.any(axis=1) if slabchg is None else \
        (slabchg[None, :] & adj).any(axis=1)
    return acts, (acts[:, None] & adjS).any(axis=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_loop_gates_sparse_equal_dense(seed):
    """K3's sparse gate rule (loop_gates_ref, the rule the kernel runs)
    equals the dense adj / adjS products on random 27-neighbour tables with
    a garbage row and padding rows past it, for the first sweep's gates and
    for random changed-slab sets."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(20, 60))           # garbage row index
    N = -(-(cap + 1 + int(rng.integers(0, 20))) // 8) * 8
    nsl = rng.integers(0, cap + 1, (27, N)).astype(np.int32)
    nsl[13] = np.minimum(np.arange(N), cap)
    nsl[rng.random((27, N)) < 0.3] = cap      # missing neighbours
    nsl[:, cap:] = cap
    upd = ((rng.random(N) < 0.6) & (np.arange(N) < cap)).astype(np.int32)
    cases = [None] + [rng.random(N // 8) < p for p in (0.0, 0.1, 0.5)]
    for chg in cases:
        want = _dense_gates(nsl, upd, chg)
        got = tk.loop_gates_ref(
            torch.from_numpy(nsl), torch.from_numpy(upd),
            None if chg is None else torch.from_numpy(chg))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b.numpy())
    assert want[1].any() or not upd.any()


def test_max_v_is_the_largest_row_that_fits():
    """MAX_V, which the card wrappers check, is kMaxV in the CUDA source
    and the largest V whose row's shared memory fits in a CTA."""
    import re
    from pathlib import Path
    src = (Path(tk.__file__).resolve().parents[2] / "csrc" /
           "esdf_sweep.cu").read_text()
    assert int(re.search(r"constexpr int kMaxV = (\d+);", src).group(1)) \
        == tk.MAX_V
    assert tk.row_smem_bytes(tk.MAX_V) <= tk.MAX_SMEM < \
        tk.row_smem_bytes(tk.MAX_V + 1)
    assert tk.row_smem_bytes(16) == 110760   # 108 KB: two CTAs per SM


def _cu_int(name):
    """An int constant of csrc/esdf_sweep.cu (``constexpr int name = n``,
    alone or in a list)."""
    import re
    from pathlib import Path
    src = (Path(tk.__file__).resolve().parents[2] / "csrc" /
           "esdf_sweep.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))


def test_cluster_rule_fits_every_row_up_to_max_cluster_v():
    """MAX_CLUSTER_V and MAX_CLUSTER are the CUDA source's; every V from
    MAX_V + 1 to MAX_CLUSTER_V gets a cluster of 2-8 CTAs whose share of the
    row fits in a CTA's 227 KB, each CTA owning at least one plane; V = 41
    fits no portable cluster, so it keeps the device-memory build."""
    assert _cu_int("kMaxClusterV") == tk.MAX_CLUSTER_V == 40
    assert _cu_int("kMaxCluster") == tk.MAX_CLUSTER == 8
    for V in range(tk.MAX_V + 1, tk.MAX_CLUSTER_V + 1):
        C = tk.cluster_ctas(V)
        assert 2 <= C <= tk.MAX_CLUSTER, V
        assert tk.row_cluster_smem_bytes(V, C) <= tk.MAX_SMEM, V
        assert C == 2 or tk.row_cluster_smem_bytes(V, C - 1) > tk.MAX_SMEM
        assert (C - 1) * tk.cluster_planes(V, C) < V, V
    V = tk.MAX_CLUSTER_V + 1
    assert tk.row_cluster_smem_bytes(V, tk.MAX_CLUSTER) > tk.MAX_SMEM
    assert tk.cluster_ctas(V) == 0
    assert [tk.cluster_ctas(V) for V in (21, 24, 28, 32, 40)] == \
        [2, 2, 3, 4, 8]
    # the constant-shape cluster builds split their rows evenly
    for V in tk.CLUSTER_FAST_V:
        assert V % tk.cluster_ctas(V) == 0


def test_kernel_build_follows_v():
    """The build each V runs, as the launch functions choose it from the
    CUDA source's constants; no device memory is asked for up to
    MAX_CLUSTER_V."""
    assert (_cu_int("kFastV"), _cu_int("kSmallV")) == (tk.FAST_V, tk.SMALL_V)
    assert (_cu_int("kClusterV24"), _cu_int("kClusterV32")) == \
        tk.CLUSTER_FAST_V
    want = {7: "<0>", 8: "<8>", 16: "<16>", 20: "<0>", 21: "_cl<0>",
            24: "_cl<24>", 28: "_cl<0>", 32: "_cl<32>", 40: "_cl<0>"}
    for V, tail in want.items():
        assert tk.kernel_build("k2", V) == "k2_kernel" + tail
        assert tk.kernel_build("k3", V) == "k3_loop_kernel" + tail
        assert tk._scratch(8, V, torch.device("cpu")) == (None, 0)
    assert tk.kernel_build("k2", 41) == "k2_kernel_gm"
    assert tk.kernel_build("k3", 44) == "k3_loop_kernel<-1>"


def test_check_interval_runs_interval_one():
    """esdf_check_interval=1 runs the interactive per-frame verdicts and 4
    the deferred path (one F = 1 sequence per frame, a verdict every four
    frames), each as the JAX model with the same interval runs it: every
    frame's ESDF, fixed flags, pending wavefront, sweeps and buckets."""
    from taichislam_tpu.models.dense_esdf import DenseESDF as JESDF
    from taichislam_tpu_torch.models.dense_esdf import DenseESDF
    from taichislam_tpu_torch.utils.synthetic_scene import (D435_K,
                                                            orbit_sequence)
    K = (D435_K * np.float32(0.1)).astype(np.float32)
    K[8] = 1.0
    depth, Rs, Ts, K = orbit_sequence(n_frames=12, h=48, w=64, K=K)
    kw = dict(map_scale=[6.4, 6.4], voxel_scale=0.1,
              num_voxel_per_blk_axis=8, max_ray_length=2.0, max_blocks=512,
              max_bins=8192, max_submap_num=8, max_esdf_sweeps=6,
              esdf_dense_max_voxels=0)
    pairs = []
    for interval in (1, 4):
        jm = JESDF(esdf_check_interval=interval, **kw)
        jm.cfg = dataclasses.replace(jm.cfg, pallas_accum="on",
                                     pallas_esdf="on", esdf_loop_kernel="off")
        tm = DenseESDF(esdf_check_interval=interval, device="cpu", **kw)
        assert tm.esdf_check_interval == interval
        for m in (jm, tm):
            m.set_dep_camera_intrinsic(K)
        pairs.append((jm, tm))
    for f in range(5):
        for jm, tm in pairs:
            for m in (jm, tm):
                m.recast_depth_to_map(Rs[f], Ts[f], depth[f], None)
            np.testing.assert_allclose(np.asarray(jm.esdf), tm.esdf.numpy(),
                                       rtol=0, atol=1e-5)
            for a, b in ((jm.esdf_fixed, tm.esdf_fixed),
                         (jm._esdf_pending, tm._esdf_pending),
                         (jm.state.table, tm.state.table)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            for name in ("last_esdf_sweeps", "_esdf_last_mode",
                         "_bin_bucket", "_esdf_cap_bucket", "_esdf_frame"):
                assert getattr(jm, name) == getattr(tm, name), (f, name)
    (_, one), (_, four) = pairs
    assert one._frame_pack is None and four._frame_pack is not None
    assert not torch.equal(one.esdf, four.esdf)
    assert int(one.esdf_observed.sum()) > 0
