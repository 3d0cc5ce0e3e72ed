"""The scene renders the same frames for the same seed, and the same sizes
and orbit for every seed; the mix's keyframe rule flags the frames."""

import json

import numpy as np
import pytest
import torch

from benchmark.cells import HERE
from benchmark.harness import Frames, NodeDriver
from benchmark.scenes import office

K = np.array([384.2377, 0, 323.4873, 0, 384.2377, 235.0628, 0, 0, 1],
             np.float32)


def _traffic(**kw):
    t = json.loads((HERE / "traffic" / "orbit30.json").read_text())
    return dict(t, height=48, width=64, distinct_frames=6, **kw)


def test_same_seed_same_frames():
    a = office.render(_traffic(), K, 2 ** 31 + 5, torch.device("cpu"), True)
    b = office.render(_traffic(), K, 2 ** 31 + 5, torch.device("cpu"), True)
    for k in ("depth", "texture", "Rs", "Ts"):
        assert np.array_equal(a[k], b[k])
    assert a["depth"].dtype == np.uint16 and a["texture"].dtype == np.uint8


def test_seeds_change_noise_phase_and_palette_not_sizes():
    a = office.render(_traffic(), K, 11, torch.device("cpu"), True)
    b = office.render(_traffic(), K, 12, torch.device("cpu"), True)
    assert a["depth"].shape == b["depth"].shape == (6, 48, 64)
    assert not np.array_equal(a["depth"], b["depth"])
    assert not np.array_equal(a["texture"], b["texture"])
    # the same orbit, entered at another phase
    ra = np.linalg.norm(a["Ts"][:, :2], axis=1)
    assert np.allclose(ra, 0.8) and np.allclose(
        np.linalg.norm(b["Ts"][:, :2], axis=1), 0.8)
    assert not np.allclose(a["Ts"], b["Ts"])
    # every return lies inside the room: depth > 0 and below the diagonal
    d = a["depth"][a["depth"] > 0].astype(float) / 1000
    assert d.size > 0.9 * a["depth"].size and d.max() < 8.0


class _Node:
    """Takes the staged frame and does nothing with it."""

    mapping = None

    def stage_depth(self, frame, depth, tex=None):
        self.frame = frame

    def process_taichi(self):
        pass

    def handle_comm(self):
        pass


@pytest.mark.parametrize("every,keys,boundaries", [
    (1, [True] * 25, [10, 20]),
    (0, [False] * 25, []),
    (3, [g % 3 == 0 for g in range(25)], []),       # 10, 20 no keyframes
    (5, [g % 5 == 0 for g in range(25)], [10, 20]),
])
def test_keyframe_rule_is_data(every, keys, boundaries):
    """The mix's keyframe rule sets each frame's flag, and a boundary falls
    on a keyframe at a multiple of the submap step only."""
    scene = office.render(_traffic(), K, 3, torch.device("cpu"), False)
    frames = Frames(scene, False, every)
    drv = NodeDriver(_Node(), frames, False, 0, 10, True)
    for k in range(25):
        drv.stage(k)
        assert not drv.process()
    assert [f.is_keyframe for _, _, f in drv.processed] == keys
    assert [n for n, b in enumerate(drv.boundary) if b] == boundaries
    with pytest.raises(ValueError):
        Frames(scene, False, "every")
