"""The port's models run on the CUDA card unless the caller asks for the CPU.

Built with no device, DenseTSDF, DenseESDF, Octomap, SubmapMapping and
DenseTSDF.loadMap target ``cuda``; with no card they raise, naming the
``device="cpu"`` way out, and never fall back. Whether a card is present is
decided inside each test (monkeypatched), never at import.
"""

import pytest

torch = pytest.importorskip("torch")

from taichislam_tpu_torch.models import base_map  # noqa: E402
from taichislam_tpu_torch.models import dense_tsdf  # noqa: E402
from taichislam_tpu_torch.models.dense_esdf import DenseESDF  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF  # noqa: E402
from taichislam_tpu_torch.models.octomap import Octomap  # noqa: E402
from taichislam_tpu_torch.models.submap_mapping import SubmapMapping  # noqa: E402,E501

SMALL = dict(map_scale=[3.2, 3.2], voxel_scale=0.1, num_voxel_per_blk_axis=8,
             max_blocks=64, max_submap_num=4)


def _build(kind, tmp_path, **kw):
    if kind == "DenseTSDF":
        return DenseTSDF(**SMALL, **kw)
    if kind == "DenseESDF":
        return DenseESDF(**SMALL, **kw)
    if kind == "Octomap":
        return Octomap(map_scale=[3.2, 3.2], voxel_scale=0.1, max_blocks=64,
                       max_submap_num=4, **kw)
    if kind == "SubmapMapping":
        return SubmapMapping(DenseTSDF, sub_opts=SMALL,
                             global_opts=dict(SMALL, is_global_map=True),
                             **kw)
    path = tmp_path / "map.npy"
    DenseTSDF(**SMALL, device="cpu").saveMap(str(path))
    return DenseTSDF.loadMap(str(path), **kw)


KINDS = ["DenseTSDF", "DenseESDF", "Octomap", "SubmapMapping", "loadMap"]


@pytest.mark.parametrize("kind", KINDS)
def test_no_card_and_no_device_raises(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build(kind, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_on_request(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _build(kind, tmp_path, device="cpu")
    assert m.device == torch.device("cpu")


class _Asked(Exception):
    pass


def test_default_asks_for_the_card(monkeypatch):
    """With a card present and no device given, a model puts its state on
    ``cuda``: the state allocation is asked for that device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert base_map.resolve_device(None) == torch.device("cuda")
    assert base_map.resolve_device("cpu") == torch.device("cpu")
    asked = []

    def make_state(cfg, device=None):
        asked.append(torch.device(device))
        raise _Asked

    monkeypatch.setattr(dense_tsdf.tsdf_ops, "make_tsdf_state", make_state)
    for build in (lambda: DenseTSDF(**SMALL), lambda: DenseESDF(**SMALL),
                  lambda: SubmapMapping(DenseTSDF, sub_opts=SMALL)):
        with pytest.raises(_Asked):
            build()
    assert len(asked) == 3 and all(d.type == "cuda" for d in asked)
