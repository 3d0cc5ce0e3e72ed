"""The port's bench (``taichislam_tpu_torch/bench.py``) against the JAX
bench's composition, and its sizing rule against ``bench.py:187-213``.

The window run is the JAX bench's ``run_all`` (``bench.py:122-175``): every
frame integrated and, with an ESDF cap, ``esdf_seed_dirty`` and
``esdf_update`` at budget 3 from zeroed carries, submap 0. The JAX side is
``ops/sequence.py``'s ``integrate_esdf_sequence`` (or
``integrate_depth_sequence`` without the ESDF) composed as the bench
composes it; its Pallas kernels run in interpret mode, as
``tests/test_torch_sequence.py`` runs them. Inputs: 6 orbit frames
rendered at 160 x 120 with the intrinsics scaled by 1/4 (as
``tools/bench_configs.py --quick`` scales them), 3 mm noise, seed 0; the
bench's map at float16 storage with its block count cut to 512. Bounds, as
``tests/test_torch_sequence.py`` asserts them for these ops: the window
maxima, block tables, observed and ESDF flags and the pending wavefront
exact. At float16 storage TSDF and W take the float16 bounds of
``tests/test_torch_tsdf.py`` (TSDF 4e-3, W rtol 2e-3 and atol 1e-3: two
f32 results a last bit apart round to neighbouring halves, and the stored
running mean carries that step into later frames), and so does the ESDF
seeded from that TSDF (4e-3, where ``tests/test_torch_sequence.py`` holds
it to 1e-5 at float32); each differs on at most 1 % of the voxels. The
checksum (a sum over every voxel) agrees within a relative 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.core.config import TSDFConfig as JConfig  # noqa: E402
from taichislam_tpu.ops import sequence as jseq  # noqa: E402
from taichislam_tpu.ops import tsdf as jt  # noqa: E402
from taichislam_tpu_torch import bench  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.ops import sequence as tseq  # noqa: E402
from taichislam_tpu_torch.utils.synthetic_scene import (  # noqa: E402
    D435_K, orbit_sequence)

N_FRAMES = 6
K4 = D435_K / 4.0
K4[8] = 1.0


def small_config():
    return dataclasses.replace(bench.bench_config(), max_blocks=512)


@pytest.fixture(scope="module")
def inputs():
    depth, Rs, Ts, _ = orbit_sequence(n_frames=N_FRAMES, h=120, w=160, K=K4,
                                      noise_mm=3.0)
    return depth, Rs, Ts


def jax_window(cfg, esdf_cap, budget, depth, Rs, Ts):
    """``bench.py:122-175``'s run_all through the JAX sequences: (state,
    esdf, fixed, pending, checksum, window maxima)."""
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)
                      if hasattr(cfg, f.name)})
    jcfg = dataclasses.replace(jcfg, pallas_accum="on", pallas_esdf="on",
                               esdf_loop_kernel="off")
    nb, V3 = jcfg.max_blocks + 1, jcfg.grid.voxels_per_block
    tail = (jnp.asarray(depth), jnp.zeros((len(depth), 1, 1, 3), jnp.uint8),
            jnp.asarray(Rs), jnp.asarray(Ts), jnp.asarray(K4),
            jnp.asarray(K4), jnp.int32(0))
    state = jt.make_tsdf_state(jcfg)
    esdf = fixed = pending = None
    if esdf_cap:
        state, esdf, fixed, pending, _, _, stats = \
            jseq.integrate_esdf_sequence(
                jcfg, budget, esdf_cap, state,
                jnp.zeros((nb, V3), jnp.float32),
                jnp.zeros((nb, V3), jnp.int8), jnp.zeros((nb,), bool),
                jnp.zeros((nb, V3), jnp.float32),
                jnp.zeros((nb, V3), bool), *tail)
        overflow = int(stats["max_esdf_overflow"])
    else:
        state, stats = jseq.integrate_depth_sequence(jcfg, state, *tail)
        overflow = 0
    checksum = float(jnp.sum(state.channels["TSDF"].astype(jnp.float32)) +
                     (0.0 if esdf is None else jnp.sum(esdf)))
    maxima = {"dropped": int(stats["max_dropped"]),
              "esdf_overflow": overflow,
              "bins_total": int(stats["max_bins_total"]),
              "live_lanes": int(stats["max_live_lanes"])}
    return state, esdf, fixed, pending, checksum, maxima


def assert_close_mostly_equal(want, got, atol, rtol, what):
    """Within the float16 bounds of ``tests/test_torch_tsdf.py`` and equal
    on all but 1 % of the non-zero voxels."""
    want, got = want.astype(np.float32), got.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    assert (want != got).sum() <= 1e-2 * max((want != 0).sum(), 1), what


@pytest.mark.parametrize("esdf_cap", [None, 256], ids=["fusion", "esdf"])
def test_window_matches_jax(inputs, esdf_cap):
    """The port's window run against the JAX bench's, at the primary's
    ESDF knobs (raise slack 0.5, eps 2e-3, 3 sweeps on 256 blocks, which
    this window overflows) and fusion only."""
    depth, Rs, Ts = inputs
    cfg = small_config()
    if esdf_cap:
        cfg = dataclasses.replace(cfg, esdf_raise_slack_voxels=0.5,
                                  esdf_converge_eps=2e-3)
    frames = bench.stage_frames(depth, Rs, Ts, K4, "cpu")
    bs = bench.BenchState(cfg, "cpu")
    got = bench.read_window(bench.run_window(cfg, esdf_cap, 3, bs, frames))
    js, jesdf, jfixed, jpending, jsum, jmax = jax_window(cfg, esdf_cap, 3,
                                                         depth, Rs, Ts)
    assert {k: got[k] for k in jmax} == jmax
    assert jmax["live_lanes"] > 0 and jmax["dropped"] == 0
    assert (jmax["esdf_overflow"] > 0) == bool(esdf_cap)
    np.testing.assert_allclose(got["checksum"], jsum, rtol=1e-6)
    ts = bridge.grid_state_to_numpy(bs.state)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name), err_msg=name)
    for name in ("TSDF_observed", "occupy"):
        np.testing.assert_array_equal(np.asarray(js.channels[name]),
                                      ts.channels[name], err_msg=name)
    for name, atol, rtol in (("TSDF", 4e-3, 0), ("W_TSDF", 1e-3, 2e-3)):
        assert ts.channels[name].dtype == np.float16
        assert_close_mostly_equal(np.asarray(js.channels[name]),
                                  ts.channels[name], atol, rtol, name)
    if esdf_cap:
        esdf, fixed, pending = (t.numpy() for t in bs.carries[:3])
        np.testing.assert_array_equal(np.asarray(jfixed), fixed)
        np.testing.assert_array_equal(np.asarray(jpending), pending)
        obs = np.asarray(jfixed) != 0
        assert obs.any()
        assert_close_mostly_equal(np.asarray(jesdf)[obs], esdf[obs], 4e-3,
                                  0, "ESDF")
    else:
        assert not any(t.any() for t in bs.carries)


def test_window_resets_in_place(inputs):
    """Sizing and timing on the CPU: the rule settles, every timed pass
    restarts from the entry state in place (same checksum, same tensors),
    nothing drops, no graph is captured and no kernel launches."""
    depth, Rs, Ts = inputs
    cfg = small_config()
    frames = bench.stage_frames(depth, Rs, Ts, K4, "cpu")
    bs = bench.BenchState(cfg, "cpu")
    ptrs = [t.data_ptr() for t in (bs.state.table, *bs.state.channels.values(),
                                   *bs.carries)]
    captures = tseq.graph_cache.captures
    r = bench.size_and_time(cfg, None, 6, bs, frames)
    assert r["bench_state"] is bs
    assert [t.data_ptr() for t in (bs.state.table,
                                   *bs.state.channels.values(),
                                   *bs.carries)] == ptrs
    assert r["timed_captures"] == 0 and tseq.graph_cache.captures == captures
    assert r["launches_per_frame"] == {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    assert len(r["passes_ms"]) == bench.PASSES
    assert r["ms_per_frame"] == min(r["passes_ms"]) / N_FRAMES
    w = r["window"]
    assert w["dropped"] == 0 and w["bins_total"] <= r["cfg"].max_bins
    # the rule's fixed point: one more step moves nothing
    assert bench.next_capacities(r["cfg"], None, w)[2]
    fresh = bench.BenchState(r["cfg"], "cpu")
    again = bench.read_window(bench.run_window(r["cfg"], None, 6, fresh,
                                               frames))
    assert again == w


def _cfg(**kw):
    return dataclasses.replace(bench.bench_config(), **kw)


def _w(dropped=0, esdf_overflow=0, bins_total=3929, live_lanes=227493):
    return dict(checksum=0.0, dropped=dropped, esdf_overflow=esdf_overflow,
                bins_total=bins_total, live_lanes=live_lanes)


# (start cfg, esdf cap, window maxima) -> (cfg changes, esdf cap, done),
# transcribed from bench.py:187-213
RULE_CASES = {
    # an ESDF overflow doubles the cap until it covers cap + overflow, and
    # moves nothing else
    "esdf_overflow": (_cfg(), 256, _w(esdf_overflow=11), {}, 512, False),
    "esdf_overflow_twice": (_cfg(), 256, _w(esdf_overflow=300), {}, 1024,
                            False),
    "esdf_overflow_with_drop": (_cfg(), 256, _w(dropped=4, esdf_overflow=1),
                                {}, 512, False),
    # a fusion drop grows the bins to the worst frame's bucket, re-buckets
    # the lanes and doubles the touched blocks
    "drop_grows": (_cfg(), None, _w(dropped=7, bins_total=9000), dict(
        max_bins=10240, max_march_lanes=262144, max_touched_blocks=512),
        None, False),
    # ... never shrinking the bins
    "drop_keeps_bins": (_cfg(), None, _w(dropped=7), dict(
        max_bins=8192, max_march_lanes=262144, max_touched_blocks=512),
        None, False),
    # no drop, the worst frame's bucket under the bins: shrink both
    "shrink": (_cfg(), None, _w(), dict(max_bins=5120,
                                        max_march_lanes=262144), None,
               False),
    # no drop, bins at the bucket, lanes off it: re-bucket the lanes only
    "lanes_only": (_cfg(max_bins=5120), None, _w(),
                   dict(max_march_lanes=262144), None, False),
    "lanes_grow": (_cfg(max_bins=5120, max_march_lanes=131072), None, _w(),
                   dict(max_march_lanes=262144), None, False),
    # nothing moves: stop
    "stop": (_cfg(max_bins=5120, max_march_lanes=262144), 256, _w(), {},
             256, True),
    "stop_bins_above": (_cfg(max_bins=4096, max_march_lanes=262144), None,
                        _w(bins_total=4000), {}, None, True),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_next_capacities_is_the_bench_rule(case):
    cfg, cap, w, changes, want_cap, want_done = RULE_CASES[case]
    got_cfg, got_cap, done = bench.next_capacities(cfg, cap, w)
    assert got_cfg == dataclasses.replace(cfg, **changes)
    assert (got_cap, done) == (want_cap, want_done)
