"""The reference against the program on the CPU, and ``correct`` coming out
false when the timed path is broken underneath: a step that leaves the map
unchanged, half of each frame left out, an answer altered where it is
produced, and in the ESDF cell a field altered in 5 % of its voxels or a
sweep loop stopped after one sweep. The harness's look for a card is
skipped: these runs take the CPU at a small size; the limits are the
cells' own."""

import numpy as np
import pytest

from benchmark.tests.helpers import CELLS, tiny_run


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_matches_reference(cell):
    line = tiny_run(cell)
    assert line["failed"] < line["attempted"]
    assert line["correct"], line["checks"]
    for name, c in line["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


def unchanged(node):
    node.mapping.recast_depth_to_map_by_frame = lambda *a, **k: None
    return node


def half_batch(node):
    real = node.mapping.recast_depth_to_map_by_frame

    def recast(frame_id, is_keyframe, pose, ext, depth, texture):
        depth = depth.copy()
        depth[depth.shape[0] // 2:] = 0
        return real(frame_id, is_keyframe, pose, ext, depth, texture)
    node.mapping.recast_depth_to_map_by_frame = recast
    return node


def altered(node):
    m = node.mapping
    if hasattr(m, "submap_collection"):
        real = m.recast_depth_to_map_by_frame

        def recast(*a):
            real(*a)
            m.submap_collection.state.channels["TSDF"].mul_(1.001)
        m.recast_depth_to_map_by_frame = recast
    else:
        pub = node.publish_pointcloud

        def publish(xyz, col, has_rgb):
            pub(np.asarray(xyz) + [m.voxel_scale, 0, 0], col, has_rgb)
        node.publish_pointcloud = publish
    return node


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_fails(cell, fault):
    line = tiny_run(cell, node_factory=fault)
    assert not line["correct"], line["checks"]


def esdf_altered(node):
    """Every 20th voxel of the field one voxel off after each update: a
    fault in 5 % of the ESDF, below the 90th percentile."""
    m = node.mapping
    real = m.update_esdf

    def update():
        real()
        m.esdf.view(-1)[::20] += m.voxel_scale
    m.update_esdf = update
    return node


def esdf_one_sweep(node):
    """The sweep loop stopped after one sweep a frame."""
    node.mapping.max_esdf_sweeps = 1
    return node


@pytest.mark.parametrize("fault", [esdf_altered, esdf_one_sweep],
                         ids=lambda f: f.__name__)
def test_esdf_fault_fails(fault):
    line = tiny_run("node_esdf_textured.orbit_backlog", node_factory=fault)
    assert not line["correct"], line["checks"]
    if fault is esdf_altered:
        # the mean sees what the percentile cannot
        c = line["checks"]
        assert c["esdf_gap"]["value"] > c["esdf_gap"]["limit"]
        assert c["esdf_gap_p90"]["value"] <= c["esdf_gap_p90"]["limit"]
