"""The node path's per-call units (``taichislam_tpu_torch/ops/graphs.py``)
on the CPU.

On the card every unit the node calls per frame (integrate, seed, the
block / window / dense ESDF, the exports, the mesher's dilation and
extraction) is one replay of a captured CUDA graph; the CPU runs the same
bodies eagerly. These tests hold what can be held here:

(a) each unit body is capturable: run after a warm-up under a dispatch
    mode that raises on a host read (``aten._local_scalar_dense``, what
    ``.item()``, ``bool()`` and ``int()`` of a tensor reach), on host data
    made into a tensor (``aten.lift_fresh``, a host-to-device copy on the
    card), on a copy to the host and on data-dependent shapes (a boolean
    index, ``nonzero``); the kernels' plain twins run outside the mode
    (on the card each is one launch);
(b) the chunked dense / window sweep loop gives the JAX
    ``esdf_update_dense``'s sweep count exactly, and its field within 2e-4
    (``tests/test_esdf.py:380``), on frames that stop at an odd sweep and
    with an odd budget;
(c) the graph keys: equal for equal inputs and addresses, different when
    a static argument, ``dims_blocks``, the submap or a written tensor
    changes, with the graph path's control flow (entries, slots, the dense
    unit's three graphs and host reads, the sequences' per-frame calls,
    clones out of the pool) run on the CPU through a stand-in for the
    capture that re-runs the body at each replay and writes its outputs
    where the first replay put them;
(d) a dense-mode ``update_esdf`` leaves ``esdf``, ``esdf_fixed`` and
    ``esdf_observed`` at their addresses;
and the node path as a whole: the textured DenseESDF at interval 1 through
window, dense and block frames, a mesh and both exports, through that
graph path on the CPU, against the JAX model on the same frames (tables,
flags, W and counts exact; TSDF within 1e-5 but where a march value's f16
rounding flips; the ESDF within the dense sweep's 2e-4) and bit for bit
against the eager bodies.

Run alone: ``python -m pytest tests/test_torch_node_graphs.py -q``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import (TorchDispatchMode,  # noqa: E402
                                          _disable_current_modes)

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.models.dense_esdf import DenseESDF as JModel  # noqa: E402,E501
from taichislam_tpu.models.mesher import MarchingCubeMesher as JMesher  # noqa: E402,E501
from taichislam_tpu.ops import esdf as je  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core.config import TSDFConfig as TConfig  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_esdf import DenseESDF as TModel  # noqa: E402,E501
from taichislam_tpu_torch.models.mesher import MarchingCubeMesher as TMesher  # noqa: E402,E501
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.ops import exports as tx  # noqa: E402
from taichislam_tpu_torch.ops import graphs  # noqa: E402
from taichislam_tpu_torch.ops import marching_cubes as tm  # noqa: E402
from taichislam_tpu_torch.ops import sequence as tseq  # noqa: E402
from taichislam_tpu_torch.ops import tsdf as tt  # noqa: E402
from taichislam_tpu_torch.utils.synthetic_scene import D435_K, orbit_sequence  # noqa: E402,E501

DEV = torch.device("cpu")
KW = dict(map_scale=(6.4, 6.4), voxel_scale=0.1, num_voxel_per_blk_axis=8,
          max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
          max_bins=8192, max_submap_num=8, esdf_raise_slack_voxels=0.5)
JCFG = JConfig(pallas_accum="on", **KW)
TCFG = TConfig(**KW)
TCFG_TEX = TConfig(**KW, texture_enabled=True, color_same_proj=False)
K = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
KC = (K * np.float32([1.1, 1, 1.02, 1, 1.08, 0.97, 1, 1, 1])).astype(
    np.float32)
SHAPE = (KW["max_blocks"] + 1, 8 ** 3)
DIMS = (8, 8, 4)


def _wall(h=48, w=64):
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (1000 + 4.0 * ii + 2.0 * jj).astype(np.uint16)


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)


def _texture(seed=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# (a) capturable bodies
# ---------------------------------------------------------------------------

class HostGuard(TorchDispatchMode):
    """Raises on what a CUDA graph capture cannot hold."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        bad = None
        if name.startswith(("aten._local_scalar_dense", "aten.item",
                            "aten.lift_fresh", "aten.nonzero",
                            "aten.masked_select")):
            bad = name
        elif name.startswith("aten._to_copy") and \
                str(kwargs.get("device", "")) == "cpu":
            bad = name + " to the host"
        elif name.startswith(("aten.index.", "aten.index_put")) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())
                if i is not None):
            bad = name + " with a boolean index"
        if bad:
            raise AssertionError(f"not capturable: {bad}")
        return func(*args, **kwargs)


@pytest.fixture
def guarded(monkeypatch):
    """``run(fn)``: ``fn()`` once as a warm-up, then under HostGuard, with
    the kernels' plain twins outside the mode (on the card each is one
    launch)."""
    from taichislam_tpu_torch.ops.kernels import esdf_sweep as ks
    from taichislam_tpu_torch.ops.kernels import seg_accum as k1

    def outside(fn):
        def call(*a, **kw):
            with _disable_current_modes():
                return fn(*a, **kw)
        return call
    monkeypatch.setattr(tt, "segmented_block_reduce",
                        outside(k1.segmented_block_reduce))
    monkeypatch.setattr(te, "esdf_sweep_loop", outside(ks.esdf_sweep_loop))
    monkeypatch.setattr(te, "esdf_sweep", outside(ks.esdf_sweep))

    def run(fn):
        fn()
        with HostGuard():
            return fn()
    return run


def test_host_guard_catches_host_work():
    """The guard sees what it is there to see."""
    t = torch.zeros(4, dtype=torch.bool)
    for bad in (lambda: bool(t.any()), lambda: int(t.sum()),
                lambda: t.__setitem__(-1, False),
                lambda: torch.tensor([1, 2]), lambda: torch.arange(4)[t]):
        with pytest.raises(AssertionError, match="not capturable"):
            with HostGuard():
                bad()
    with HostGuard():
        t[-1].fill_(False)


@pytest.fixture(scope="module")
def fused():
    """A textured map fused from two frames, its touched blocks and the
    slots of the integrate unit's inputs."""
    st = tt.make_tsdf_state(TCFG_TEX, device=DEV)
    par = [torch.from_numpy(np.concatenate([
        _rot(th).reshape(-1), np.float32([0.1, -0.2, 0.05]), K, KC]))
        for th in (0.4, 0.45)]
    depth = torch.from_numpy(_wall().astype(np.int32))
    tex = torch.from_numpy(_texture())
    for p in par:
        st, stats = tt.integrate_depth_ref(
            TCFG_TEX, st, depth, tex, p[0:9].view(3, 3), p[9:12],
            p[12:21], p[21:30], 0)
    return st, stats["touched_blocks"], depth, tex, par[0]


def _clone(st):
    from taichislam_tpu_torch.core.grid import clone_state
    return clone_state(st)


def test_integrate_bodies_are_capturable(guarded, fused):
    st0, _, depth, tex, par = fused
    st = _clone(st0)
    guarded(lambda: tt.integrate_depth_ref(
        TCFG_TEX, st, depth, tex, par[0:9].view(3, 3), par[9:12],
        par[12:21], par[21:30], 0))
    xyz = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.5, 1.5, (500, 3)).astype(np.float32))
    rgb = torch.full((500, 3), 90.0)
    guarded(lambda: tt.integrate_pcl_ref(TCFG_TEX, st, xyz, rgb,
                                         par[0:9].view(3, 3), par[9:12], 0))


def test_esdf_bodies_are_capturable(guarded, fused):
    st, touched, *_ = fused
    seen_t = torch.zeros(SHAPE)
    seen_o = torch.zeros(SHAPE, dtype=torch.bool)
    dirty, _, _ = guarded(lambda: te.esdf_seed_dirty_ref(
        TCFG_TEX, st, seen_t, seen_o, touched))
    e, f = torch.zeros(SHAPE), torch.zeros(SHAPE, dtype=torch.int8)
    for budget in (6, 1):   # K3, then K2's per-sweep path
        guarded(lambda: te.esdf_update_ref(
            TCFG_TEX, budget, 64, st, e, f, 0, dirty, tsdf_src=seen_t,
            obs_src=seen_o))
    for dirty_blocks in (None, dirty):   # dense, window
        d = guarded(lambda: te._dense_setup(
            TCFG_TEX, DIMS, st, e, f, 0, dirty_blocks, None, None))
        guarded(lambda: te._dense_sweeps(TCFG_TEX, d, 2))
        guarded(lambda: te._dense_finish(TCFG_TEX, DIMS, d, e, f,
                                         dirty_blocks is not None))


def test_export_and_mesh_bodies_are_capturable(guarded, fused):
    st, touched, *_ = fused
    base_R = torch.eye(3).repeat(8, 1, 1)
    base_T = torch.zeros((8, 3))
    guarded(lambda: tx.tsdf_surface_export_ref(TCFG_TEX, 4096, 64, st,
                                               base_R, base_T, 0))
    esdf = torch.zeros(SHAPE)
    obs = st.channels["TSDF_observed"] > 0
    guarded(lambda: te.esdf_slice_export_ref(TCFG_TEX, 4096, 64, st, esdf,
                                             obs, base_R, base_T, 0, 0.0,
                                             0.5))
    dil = guarded(lambda: tm.dilate_blocks_ref(TCFG_TEX, st, 0, touched))
    for mask in (None, dil):
        guarded(lambda: tm.extract_mesh_ref(TCFG_TEX, 4096, 1, 64, st, 0,
                                            0.5, block_mask=mask))


# ---------------------------------------------------------------------------
# (b) the chunked sweep loop against the JAX while-loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wall():
    st, stats = jt.integrate_depth(
        JCFG, jt.make_tsdf_state(JCFG), jnp.asarray(_wall()),
        jnp.zeros((1, 1, 3), jnp.uint8), jnp.asarray(_rot(0.4)),
        jnp.asarray([0.1, -0.2, 0.05], np.float32), jnp.asarray(K),
        jnp.asarray(K), jnp.int32(0))
    return st, np.asarray(stats["touched_blocks"])


def _dense_pair(jstate, e0, f0, budget, dirty=None):
    kw = {} if dirty is None else {"dirty_blocks": dirty}
    want = je.esdf_update_dense(
        JCFG, budget, DIMS, jstate, jnp.asarray(e0), jnp.asarray(f0),
        jnp.int32(0), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = te.esdf_update_dense(
        TCFG, budget, DIMS, bridge.grid_state_from_numpy(jstate, device=DEV),
        torch.from_numpy(np.array(e0)), torch.from_numpy(np.array(f0)), 0,
        **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    obs = want[2]
    err = float(np.abs(np.where(obs, want[0] - got[0], 0.0)).max())
    return int(want[3]), int(got[3]), err, got


@pytest.mark.parametrize("mode", ["dense", "window"])
def test_chunked_loop_sweeps_match_jax(wall, mode):
    """Budgets cut the loop at every parity; the converged run, its warm
    restart and the budgets stop at odd sweeps too."""
    jstate, touched = wall
    e0 = np.zeros(SHAPE, np.float32)
    f0 = np.zeros(SHAPE, np.int8)
    dirty = touched if mode == "window" else None
    seen = []
    for budget in (1, 2, 3, 5, 8, 64):
        w, g, err, got = _dense_pair(jstate, e0, f0, budget, dirty)
        assert w == g, (budget, w, g)
        assert err <= 2e-4, (budget, err)
        seen.append(g)
    full = got
    # warm restart on the converged field: few sweeps
    w, g, err, _ = _dense_pair(jstate, full[0], full[1], 64, dirty)
    assert w == g and err <= 2e-4, (w, g, err)
    seen.append(g)
    assert any(s % 2 == 1 for s in seen), seen   # a stop mid-chunk
    assert seen[-2] < 64, seen                   # converged before budget


# ---------------------------------------------------------------------------
# (c) the graph path on the CPU: keys, entries and the dense unit's graphs
# ---------------------------------------------------------------------------

class ReplayedBody:
    """Stands in for ``graphs.Captured`` on the CPU: capturing runs
    nothing; every replay runs the body and leaves its outputs where the
    first replay put them, as a graph's pool does."""

    def __init__(self, fn, own=()):
        self.fn, self.own = fn, own
        self.out, self.tally, self.replays = None, [], 0

    def replay(self):
        self.replays += 1
        with graphs.bodies():
            res = graphs.strip(self.fn(), self.own)
        if self.out is None:
            self.out = res
        else:
            _write_into(self.out, res)
        return self.out

    def release(self):
        pass


def _write_into(dst, src):
    if isinstance(dst, graphs._Own):
        return
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _write_into(a, b)


@pytest.fixture
def graph_path(monkeypatch):
    """Route the units' CPU calls through their graph path."""
    def stage(slot, x):
        slot.copy_(x if isinstance(x, torch.Tensor) else
                   torch.from_numpy(np.ascontiguousarray(x)))
    monkeypatch.setattr(graphs, "eager",
                        lambda t: getattr(graphs._tls, "bodies", 0) > 0)
    monkeypatch.setattr(graphs, "Captured", ReplayedBody)
    monkeypatch.setattr(graphs, "stage", stage)
    graphs.clear()
    graphs.reset_counts()
    yield graphs.UNITS
    graphs.clear()
    graphs.reset_counts()


def test_dense_keys_and_graphs(graph_path, wall):
    """Equal inputs at equal addresses share an entry, which captures on
    its second call; a static argument, the window dims, the submap or a
    written tensor makes a new one. The graph path equals the eager body
    bit for bit and takes the while-loop's sweep count."""
    unit = te.ESDF_DENSE
    jstate, touched = wall
    st = bridge.grid_state_from_numpy(jstate, device=DEV)
    e0, f0 = torch.zeros(SHAPE), torch.zeros(SHAPE, dtype=torch.int8)
    dirty = torch.from_numpy(np.array(touched))

    def run(budget=64, dims=DIMS, submap=0, e=e0):
        return te.esdf_update_dense(TCFG, budget, dims, st, e, f0, submap,
                                    dirty_blocks=dirty)
    want = te.esdf_update_dense_ref(TCFG, 5, DIMS, st, e0, f0, 0,
                                    dirty_blocks=dirty)
    outs = [run(budget=5) for _ in range(3)]
    assert len(unit.entries) == 1
    (entry,) = unit.entries.values()
    assert entry.calls == 3 and unit.eager_calls == 1
    # setup, the 2-sweep chunk, the 1-sweep tail, finish
    assert sorted(entry.graphs) == ["finish", "setup", "sweeps1", "sweeps2"]
    for out in outs:
        for a, b in zip(want, out):
            assert torch.equal(a, b)
    assert outs[1][0] is not outs[2][0]   # clones out of the pool
    seen = set(unit.entries)
    for kw in (dict(budget=64), dict(dims=(8, 8, 8)), dict(submap=1),
               dict(e=e0.clone())):
        run(**kw)
        run(**kw)
        k = next(reversed(unit.entries))   # the most recently used
        assert k not in seen and unit.entries[k].graphs, kw
        seen.add(k)


def test_captured_outputs_hold_no_caller_state(fused):
    """A captured body's outputs keep placeholders for the caller's objects
    (a cached graph must not keep a dead model's state alive); a replay
    hands back the caller's objects and clones of the rest."""
    import gc
    import weakref
    st = _clone(fused[0])
    stats = {"touched": torch.ones(3, dtype=torch.bool)}
    out = graphs.strip((st, stats), [st])
    ref = weakref.ref(st.table)
    back = graphs.detach(out, [st])
    assert back[0] is st and back[1]["touched"] is not stats["touched"]
    assert torch.equal(back[1]["touched"], stats["touched"])
    del st, back
    gc.collect()
    assert ref() is None


def test_unit_keys(graph_path, fused):
    """The integrate unit's key: the cfg bucket, the submap and the state
    addresses, not the frame's values."""
    st0, _, depth, tex, par = fused
    unit = tt.INTEGRATE_DEPTH
    st = _clone(st0)
    R, T = par[0:9].view(3, 3), par[9:12]

    def run(cfg=TCFG_TEX, state=st, submap=0, d=depth):
        tt.integrate_depth(cfg, state, d, tex, R, T, par[12:21], par[21:30],
                           submap)
    run()
    run(d=depth + 3)
    assert len(unit.entries) == 1
    assert unit.captures == 1 and unit.replays == 1
    run(cfg=dataclasses.replace(TCFG_TEX, max_bins=4096))
    run(submap=1)
    run(state=_clone(st0))
    assert len(unit.entries) == 4


@pytest.mark.parametrize("esdf", [False, True], ids=["tsdf", "esdf"])
def test_sequence_keys_and_graphs(graph_path, esdf):
    """The sequences on the units' protocol: a textured window of three
    frames, run twice through the graph path, equals the eager ``*_ref``
    loop on a clone bit for bit (state, ESDF carries, stats); it takes one
    entry, run eagerly at its first frame, captured at its second and
    replayed after; another active submap makes a new entry."""
    unit = tseq.graph_cache
    F = 3
    depths = torch.from_numpy(np.stack(
        [_wall().astype(np.int32) + 20 * f for f in range(F)]))
    texs = torch.from_numpy(np.stack([_texture(f) for f in range(F)]))
    Rs = np.stack([_rot(0.4 + 0.05 * f) for f in range(F)])
    Ts = np.tile(np.float32([0.1, -0.2, 0.05]), (F, 1))
    st = tt.make_tsdf_state(TCFG_TEX, device=DEV)
    es = (torch.zeros(SHAPE), torch.zeros(SHAPE, dtype=torch.int8),
          torch.zeros(SHAPE[:1], dtype=torch.bool), torch.zeros(SHAPE),
          torch.zeros(SHAPE, dtype=torch.bool)) if esdf else ()
    ref = (_clone(st),) + tuple(t.clone() for t in es)

    def run(graph, written, submap=0):
        args = (depths, texs, Rs, Ts, K, KC, submap)
        if esdf:
            fn = tseq.integrate_esdf_sequence if graph else \
                tseq.integrate_esdf_sequence_ref
            return fn(TCFG_TEX, 6, 64, *written, *args)[-1]
        fn = tseq.integrate_depth_sequence if graph else \
            tseq.integrate_depth_sequence_ref
        return fn(TCFG_TEX, *written, *args)[-1]
    for window in range(2):
        got, want = run(True, (st,) + es), run(False, ref)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for a, b in zip(graphs.leaves((st,) + es), graphs.leaves(ref)):
            assert torch.equal(a, b)
        assert len(unit.entries) == 1 and unit.eager_calls == 1
        assert unit.captures == 1 and unit.replays == F * (window + 1) - 1
    assert int(st.num_blocks) > 0 and bool(got["touched_blocks"].any())
    seen = set(unit.entries)
    run(True, (st,) + es, submap=1)
    assert len(unit.entries) == 2 and next(reversed(unit.entries)) not in seen
    assert unit.eager_calls == 2


# ---------------------------------------------------------------------------
# (d) in-place ESDF writes, and the node path as a whole
# ---------------------------------------------------------------------------

MODEL = dict(map_scale=[6.4, 6.4], voxel_scale=0.1, num_voxel_per_blk_axis=8,
             max_ray_length=2.0, min_ray_length=0.3, max_blocks=512,
             max_bins=8192, max_submap_num=8, max_esdf_sweeps=6,
             esdf_raise_slack_voxels=0.5, texture_enabled=True,
             color_same_proj=False)


def _small_K():
    k = (D435_K * np.float32(0.1)).astype(np.float32)
    k[8] = 1.0
    return k


def _port(budget, dev=DEV):
    m = TModel(**MODEL, esdf_dense_max_voxels=budget, device=dev)
    kd = _small_K()
    m.set_dep_camera_intrinsic(kd)
    m.set_color_camera_intrinsic(_color_K(kd))
    return m


def _color_K(kd):
    kc = kd.copy()
    kc[[0, 2, 4, 5]] *= np.float32([1.1, 1.02, 1.08, 0.97])
    return kc


def _addresses(m):
    return [t.data_ptr() for t in (m.esdf, m.esdf_fixed, m.esdf_observed)]


def test_update_esdf_writes_in_place():
    depth, Rs, Ts, _ = orbit_sequence(n_frames=3, h=48, w=64, K=_small_K())
    m = _port(256 * 512)   # the window gives way to the dense mode
    before = _addresses(m)
    for f in range(2):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f], _texture(f))
    assert m._esdf_last_mode == "dense"
    assert _addresses(m) == before
    assert int(m.esdf_observed.sum()) > 0


# the budgets that take the node path through window, dense and block
# frames (tests/test_torch_slice.py's)
PATHS = [(2 * 1024 * 1024, ["window"] * 3),
         (256 * 512, ["window", "dense", "dense"]),
         (96 * 512, ["dense", "block", "block"])]


def _drive(m, mesher, frames, n):
    depth, Rs, Ts = frames
    out = []
    for f in range(n):
        m.recast_depth_to_map(Rs[f], Ts[f], depth[f], _texture(f))
        out.append((m._esdf_last_mode, m.last_esdf_sweeps,
                    m.last_esdf_dirty))
    mesher.generate_mesh(1)
    m.cvt_TSDF_surface_to_voxels()
    m.cvt_ESDF_to_voxels_slice(0.0)
    return out


def _within_1e5(want, got, n_obs):
    """Within 1e-5 but where an accumulation-order ulp of a ray bin's sums
    (K1 against the JAX kernel in interpret mode) flips the f16 rounding of
    a march value (``vals_f16``): at most 0.1 % of the observed voxels,
    each within 1e-3 (one f16 step of the value; ROADMAP.md, "In the
    reference, left as is")."""
    err = np.abs(want - got)
    off = int((err > 1e-5).sum())
    assert off <= max(2, n_obs // 1000) and err.max() <= 1e-3, \
        (off, float(err.max()), int(n_obs))


def _maps_equal(a, b):
    for f in a.state._fields:
        if f != "channels":
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    for k in a.state.channels:
        assert torch.equal(a.state.channels[k], b.state.channels[k]), k
    for n in ("esdf", "esdf_fixed", "esdf_observed", "_esdf_pending",
              "_esdf_seen_tsdf", "_esdf_seen_obs"):
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@pytest.mark.parametrize("budget,modes", PATHS,
                         ids=["window", "window_dense", "dense_block"])
def test_node_path_matches_jax_and_eager(graph_path, budget, modes):
    """Three textured frames, then one mesh and both exports: the graph
    path on the CPU against the eager bodies (bit for bit) and against the
    JAX model (tables, flags, W and counts exact, TSDF and ESDF as the
    module says)."""
    depth, Rs, Ts, _ = orbit_sequence(n_frames=3, h=48, w=64, K=_small_K())
    frames = (depth, Rs, Ts)
    tm_ = _port(budget)
    t_mesher = TMesher(tm_, 60000, tsdf_surface_thres=0.5)
    got = _drive(tm_, t_mesher, frames, 3)
    assert [g[0] for g in got] == modes
    assert sum(u.replays for u in graph_path.values()) > 0
    # the eager bodies, by name
    with graphs.bodies():
        em = _port(budget)
        e_mesher = TMesher(em, 60000, tsdf_surface_thres=0.5)
        assert _drive(em, e_mesher, frames, 3) == got
    _maps_equal(tm_, em)
    n = t_mesher.num_facelets * 3
    assert n > 0 and np.array_equal(t_mesher.mesh_vertices[:n],
                                    e_mesher.mesh_vertices[:n])
    assert np.array_equal(tm_.export_TSDF_xyz, em.export_TSDF_xyz)
    assert np.array_equal(tm_.export_ESDF, em.export_ESDF)

    jm = JModel(**MODEL, esdf_dense_max_voxels=budget)
    jm.cfg = dataclasses.replace(jm.cfg, pallas_accum="on", pallas_esdf="on",
                                 esdf_loop_kernel="off")
    jm.set_dep_camera_intrinsic(_small_K())
    jm.set_color_camera_intrinsic(_color_K(_small_K()))
    j_mesher = JMesher(jm, 60000, tsdf_surface_thres=0.5)
    assert _drive(jm, j_mesher, frames, 3) == got
    js, ts = jm.state, tm_.state
    for name in ("table", "block_coords", "num_blocks", "alloc_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ts.channels[name].numpy())
    obs = np.asarray(jm.esdf_observed)
    np.testing.assert_array_equal(obs, tm_.esdf_observed.numpy())
    np.testing.assert_array_equal(np.where(obs, np.asarray(jm.esdf_fixed), 0),
                                  np.where(obs, tm_.esdf_fixed.numpy(), 0))
    np.testing.assert_array_equal(np.asarray(jm._esdf_pending),
                                  tm_._esdf_pending.numpy())
    np.testing.assert_array_equal(np.asarray(js.channels["W_TSDF"]),
                                  ts.channels["W_TSDF"].numpy())
    _within_1e5(np.asarray(js.channels["TSDF"]), ts.channels["TSDF"].numpy(),
                obs.sum())
    # the window and dense frames' field: the dense sweep's own bound
    # against the JAX XLA sweep (tests/test_esdf.py:380)
    err = np.abs(np.where(obs, np.asarray(jm.esdf) - tm_.esdf.numpy(), 0))
    assert err.max() <= 2e-4, err.max()
    assert jm.num_TSDF_particles == tm_.num_TSDF_particles > 0
    assert jm.num_export_ESDF_particles == tm_.num_export_ESDF_particles > 0
    assert j_mesher.num_facelets == t_mesher.num_facelets
