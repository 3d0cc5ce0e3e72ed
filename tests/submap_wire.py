"""The submap wire payloads of an inline export, for the tests that hold a
boundary's published payloads to them (``tests/test_torch_submap.py``,
``tests/test_torch_l515_submap.py``). Imports no JAX."""

import numpy as np

from taichislam_tpu_torch.models.submap_mapping import _decode_submap_npz


def record_inline_payloads(sm):
    """Wrap ``sm``'s boundary so that, on the node's thread and just before
    the boundary's own gather, the finished submap is exported and encoded
    inline (``export_submap()`` + ``_encode``, stamped as a send stamps
    it). Returns the list the compressed payloads go into."""
    want = []
    real = sm._finalize_active_submap

    def finalize():
        obj = sm.submap_collection.export_submap()
        obj["frame_id"] = sm.active_submap_frame_id
        obj["pose"] = sm.pgo_poses[sm.active_submap_frame_id]
        want.append(sm._encode(obj)[1])
        return real()
    sm._finalize_active_submap = finalize
    return want


def decoded(sm, bufs):
    """``bufs`` decoded as ``sm`` decodes inbound payloads."""
    return [sm._decode_wire(b, _decode_submap_npz, "submap") for b in bufs]


def assert_same_payloads(sm, got, want):
    """The payloads decode to the same keys and equal values, in order."""
    assert len(got) == len(want) > 0
    for g, w in zip(decoded(sm, got), decoded(sm, want)):
        assert g.keys() == w.keys()
        for k in w:
            if k == "pose":
                for a, b in zip(g[k], w[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
