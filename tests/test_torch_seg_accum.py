"""K1 twin (segmented_block_reduce_ref) against the Pallas kernel.

The JAX side runs ``segmented_block_reduce`` in interpret mode, as the JAX
package's own tests do, with ``max_bkey`` passed to both where the JAX call
sites pass it (its packed-key path). Keys, touched counts and lanes_dropped
are exact; tiles agree to atol 1e-4 (test_pallas_accum.py's bound: the two
sum the same f32 values in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from taichislam_tpu.ops.pallas import seg_accum as jk  # noqa: E402
from taichislam_tpu_torch.ops.kernels import seg_accum as tk  # noqa: E402

V3 = 512


def _lanes(seed, n, n_blocks, invalid=0.1, n_vals=2):
    rng = np.random.default_rng(seed)
    bkey = rng.integers(0, n_blocks, n).astype(np.int32)
    bkey[rng.random(n) < invalid] = jk.SENTINEL_BLOCK
    intra = rng.integers(0, V3, n).astype(np.int32)
    vals = [rng.standard_normal(n).astype(np.float32)
            for _ in range(n_vals)]
    return bkey, intra, vals


def _compare(bkey, intra, vals, max_touched, **kw):
    want = jk.segmented_block_reduce(
        jnp.asarray(bkey), jnp.asarray(intra),
        tuple(jnp.asarray(v) for v in vals), V3, max_touched,
        interpret=True, **kw)
    got = tk.segmented_block_reduce(
        torch.from_numpy(bkey), torch.from_numpy(intra),
        [torch.from_numpy(v) for v in vals], V3, max_touched, **kw)
    touched = np.asarray(want[0])
    np.testing.assert_array_equal(touched, got[0].numpy())
    assert int(want[2]) == int(got[2])
    assert int(want[3]) == int(got[3])
    rows = touched >= 0
    np.testing.assert_allclose(np.asarray(want[1])[rows],
                               got[1].numpy()[rows], atol=1e-4)
    # the port also zeroes the rows past n_touched
    assert not got[1].numpy()[~rows].any()
    return got


@pytest.mark.parametrize("case", ["packed", "two_key", "f16", "f16_odd"])
def test_sorted_reduce_matches_pallas(case):
    bkey, intra, vals = _lanes(1, 3000, 23,
                               n_vals=3 if case == "f16_odd" else 2)
    kw = {"packed": dict(max_bkey=64), "two_key": {},
          "f16": dict(max_bkey=64, vals_f16=True),
          "f16_odd": dict(vals_f16=True)}[case]
    got = _compare(bkey, intra, vals, 32, **kw)
    assert int(got[2]) == 23


def test_presorted_single_block():
    """The per-bin call site: one block, intra = nondecreasing rank,
    invalid lanes last."""
    rng = np.random.default_rng(2)
    rank = np.sort(rng.integers(0, 700, 2500)).astype(np.int32)
    ok = rank < V3
    bkey = np.where(ok, 0, jk.SENTINEL_BLOCK).astype(np.int32)
    intra = np.where(ok, rank, 0).astype(np.int32)
    vals = [np.ones(2500, np.float32)] + [
        rng.standard_normal(2500).astype(np.float32) for _ in range(4)]
    _compare(bkey, intra, vals, 1, presorted=True)


@pytest.mark.parametrize("site", ["march5", "bins8"])
def test_textured_sites_match_pallas(site):
    """The textured call sites: the march at 5 values (Σw, Σw·d, 3 Σw·c;
    f16-rounded pairs, the odd fifth value f32) and the bins at 8 values
    (count, px, py, pz, depth, r, g, b; one presorted block)."""
    rng = np.random.default_rng(6)
    if site == "march5":
        bkey, intra, vals = _lanes(6, 4000, 30, n_vals=5)
        got = _compare(bkey, intra, vals, 32, max_bkey=64, vals_f16=True)
        assert int(got[2]) == 30
        return
    rank = np.sort(rng.integers(0, 600, 3000)).astype(np.int32)
    ok = rank < V3
    bkey = np.where(ok, 0, jk.SENTINEL_BLOCK).astype(np.int32)
    intra = np.where(ok, rank, 0).astype(np.int32)
    vals = [np.ones(3000, np.float32)] + [
        rng.standard_normal(3000).astype(np.float32) for _ in range(4)] + [
        rng.uniform(0, 255, 3000).astype(np.float32) for _ in range(3)]
    got = _compare(bkey, intra, vals, 1, presorted=True)
    assert got[1].shape == (1, 8, V3)


def test_lane_cap_counts_dropped_lanes():
    # distinct (block, intra) keys and the packed-key sort (the march call
    # site's): which lanes of the boundary block fall past the cap must not
    # depend on tie order. (The JAX two-key path sorts by block only, so
    # with a cap its kept lanes of that block are arbitrary.)
    bkey, intra, vals = _lanes(3, 6000, 40, invalid=0.05)
    key = np.random.default_rng(3).choice(40 * V3, 6000, replace=False)
    valid = bkey < jk.SENTINEL_BLOCK
    bkey = np.where(valid, key // V3, bkey).astype(np.int32)
    intra = (key % V3).astype(np.int32)
    got = _compare(bkey, intra, vals, 64, lane_cap=2500, max_bkey=64)
    assert int(got[3]) > 0     # cap rounds to 4096 < 5700 valid lanes


def test_touched_overflow_is_counted():
    bkey, intra, vals = _lanes(4, 2048, 90)
    got = _compare(bkey, intra, vals, 16)
    assert int(got[2]) == 90 and int((got[0] >= 0).sum()) == 16


def test_wrapper_rejects_bad_inputs():
    bkey, intra, vals = _lanes(5, 64, 4)
    with pytest.raises(ValueError):
        tk.segmented_block_reduce(torch.from_numpy(bkey).long(),
                                  torch.from_numpy(intra),
                                  [torch.from_numpy(v) for v in vals], V3, 8)
    with pytest.raises(ValueError):
        tk.segmented_block_reduce(torch.from_numpy(bkey),
                                  torch.from_numpy(intra),
                                  [torch.from_numpy(vals[0])] * 9, V3, 8)


@pytest.mark.parametrize("n_blocks,lanes", [(5, 1024), (37, 2048), (1, 256)])
def test_segmented_accumulate_matches_pallas(n_blocks, lanes):
    """The back-compat wrapper over packed keys, at the shapes of
    test_pallas_accum.py's reference test."""
    rng = np.random.default_rng(n_blocks)
    keys = (rng.integers(0, n_blocks, lanes) * V3 +
            rng.integers(0, V3, lanes)).astype(np.int32)
    keys[rng.random(lanes) < 0.1] = jk.SENTINEL_KEY
    w = rng.random(lanes).astype(np.float32)
    wd = rng.standard_normal(lanes).astype(np.float32)
    want = jk.segmented_block_accumulate(jnp.asarray(keys), jnp.asarray(w),
                                         jnp.asarray(wd), V3, max_touched=64,
                                         interpret=True)
    got = tk.segmented_block_accumulate(torch.from_numpy(keys),
                                        torch.from_numpy(w),
                                        torch.from_numpy(wd), V3, 64)
    touched = np.asarray(want[0])
    np.testing.assert_array_equal(touched, got[0].numpy())
    assert int(want[2]) == int(got[2]) == n_blocks
    rows = touched >= 0
    np.testing.assert_allclose(np.asarray(want[1])[rows],
                               got[1].numpy()[rows], atol=1e-4)


def test_fusion_shape_v1000_six_values():
    """K1's twin at the submap fusion site of a V = 10 grid: V³ = 1000 (not
    a multiple of 128, so the Pallas kernel cannot take it), 6 values, not
    presorted, no lane cap. Held against a numpy reference."""
    V3_ = 1000
    rng = np.random.default_rng(8)
    n = 6000
    bkey = rng.integers(0, 50, n).astype(np.int32)
    bkey[rng.random(n) < 0.2] = tk.SENTINEL_BLOCK
    intra = rng.integers(0, V3_, n).astype(np.int32)
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(6)]
    touched, acc, n_touched, dropped = tk.segmented_block_reduce(
        torch.from_numpy(bkey), torch.from_numpy(intra),
        [torch.from_numpy(v) for v in vals], V3_, 64)
    ok = bkey < tk.SENTINEL_BLOCK
    blocks = np.unique(bkey[ok])
    assert int(n_touched) == len(blocks) and int(dropped) == 0
    np.testing.assert_array_equal(touched.numpy()[:len(blocks)], blocks)
    want = np.zeros((len(blocks), 6, V3_), np.float64)
    row = np.searchsorted(blocks, bkey[ok])
    for v in range(6):
        np.add.at(want[:, v], (row, intra[ok]), vals[v][ok])
    np.testing.assert_allclose(acc.numpy()[:len(blocks)], want, atol=1e-5)


def _site(name, seed=9):
    """K1's five call sites scaled down: (bkey, intra, vals, kwargs, max_bkey
    as the call site passes it, or the bound its keys keep)."""
    rng = np.random.default_rng(seed)
    if name in ("bins", "bins8"):
        n = 3000
        rank = np.unique(np.sort(rng.integers(0, 700, n)),
                         return_inverse=True)[1].astype(np.int32)
        ok = rank < V3
        bkey = np.where(ok, 0, jk.SENTINEL_BLOCK).astype(np.int32)
        intra = np.where(ok, rank, 0).astype(np.int32)
        vals = [np.ones(n, np.float32)] + [
            rng.standard_normal(n).astype(np.float32)
            for _ in range(4 if name == "bins" else 7)]
        return bkey, intra, vals, dict(presorted=True), 1
    n_vals = {"march": 2, "march5": 5, "fusion": 6}[name]
    bkey, intra, vals = _lanes(seed, 5000, 40, invalid=0.2, n_vals=n_vals)
    kw = {"march": dict(lane_cap=4000, vals_f16=True),
          "march5": dict(vals_f16=True), "fusion": {}}[name]
    return bkey, intra, vals, kw, 64


@pytest.mark.parametrize("site", ["march", "bins", "march5", "bins8",
                                  "fusion"])
def test_twin_max_bkey_changes_nothing(site):
    """The plain twin with ``max_bkey`` (as the call sites now pass it) gives
    exactly what it gives without it, at all five site shapes."""
    bkey, intra, vals, kw, mb = _site(site)
    args = (torch.from_numpy(bkey), torch.from_numpy(intra),
            [torch.from_numpy(v) for v in vals], V3, 48)
    want = tk.segmented_block_reduce_ref(*args, **kw)
    got = tk.segmented_block_reduce_ref(*args, max_bkey=mb, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int(want[2]) > 0


def test_keys_past_max_bkey_are_invalid():
    """A lane whose block key is max_bkey or more counts as invalid in the
    plain twin. This test covers only the twin; the kernel is held to it on
    the card by chip_smoke.py phase 2 (a lane cap inside a block with keys
    past max_bkey)."""
    bkey, intra, vals = _lanes(12, 3000, 60)
    args = (torch.from_numpy(intra), [torch.from_numpy(v) for v in vals],
            V3, 64)
    got = tk.segmented_block_reduce_ref(torch.from_numpy(bkey), *args,
                                        max_bkey=30)
    cut = np.where(bkey < 30, bkey, jk.SENTINEL_BLOCK).astype(np.int32)
    want = tk.segmented_block_reduce_ref(torch.from_numpy(cut), *args)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_lane_cap_cuts_inside_a_block():
    """The cap falls inside a block: that block keeps exactly its lanes
    before the cut (in sorted order), later blocks vanish, and the dropped
    valid lanes are counted."""
    rng = np.random.default_rng(13)
    n = 6000
    bkey = np.repeat(np.arange(3, dtype=np.int32), n // 3)
    intra = rng.integers(0, V3, n).astype(np.int32)
    perm = rng.permutation(n)
    bkey, intra = bkey[perm], intra[perm]
    vals = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    touched, acc, n_touched, dropped = tk.segmented_block_reduce(
        torch.from_numpy(bkey), torch.from_numpy(intra),
        [torch.from_numpy(v) for v in vals], V3, 4, lane_cap=3000,
        max_bkey=3)
    cap = 4096                      # 3000 rounded up to whole CHUNKs
    assert int(dropped) == n - cap
    assert int(n_touched) == 3       # block 2 starts before the cut
    np.testing.assert_array_equal(touched.numpy(), [0, 1, 2, -1])
    order = np.lexsort((intra, bkey))[:cap]
    want = np.zeros((4, 2, V3), np.float64)
    for v in range(2):
        np.add.at(want[:, v], (bkey[order], intra[order]), vals[v][order])
    kept_2 = int((bkey[order] == 2).sum())
    assert 0 < kept_2 < n // 3
    np.testing.assert_allclose(acc.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("max_bkey,V3_,presorted,want", [
    (203125, 4096, False, (203125, 4, 4)),     # the node's 100 m map
    (2197, 4096, False, (2197, 4, 3)),          # the bench's 10 m map
    (None, 4096, False, (2 ** 24, 8, 5)),       # no bound: the u64 key
    (None, 8192, True, (2 ** 24, 8, 0)),        # presorted: no sort
])
def test_kernel_plan(max_bkey, V3_, presorted, want):
    """The kernel's key width and radix passes: u32 when max_bkey * V3 <
    2^30 (the JAX package's packed-sort rule), passes over the live bits."""
    assert tk._plan(1000, V3_, presorted, max_bkey) == want
    assert tk._lane_cap(5000, 3000) == (4096, True)
    assert tk._lane_cap(5000, 4500) == (5000, False)
