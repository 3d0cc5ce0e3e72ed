#!/usr/bin/env python
"""The benchmark configurations' data fixtures, regenerated on demand.

Counterpart of the repository's ``tools/gen_fixtures.py``, over the port's
own scene generator and map. It writes, under ``build/fixtures/`` at the
root of the checkout (ignored by git):

  d435_synth_seq_<n>.npz   a D435-like depth sequence: the office orbit of
                           ``utils/synthetic_scene.py`` (depth u16
                           (n, 480, 640), Rs, Ts, K)
  ri_tsdf_equiv_<n>.npy    a saved global TSDF map in ``saveMap``'s dict
                           schema, that sequence fused into a 10 x 10 m map
                           at 5 cm (V = 16, 4096 blocks, 32,768 bins, max ray
                           5.1 m)

A file that exists is reused. Files are written whole (a temporary name,
then a rename), so concurrent callers never read half a file.

Run:  python -m taichislam_tpu_torch.tools.gen_fixtures [--frames 40]
          [--cpu]
"""

import argparse
import os
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "build" / "fixtures"

MAP_OPTS = dict(map_scale=[10.0, 10.0], voxel_scale=0.05,
                num_voxel_per_blk_axis=16, max_ray_length=5.1,
                min_ray_length=0.3, max_blocks=4096, max_bins=32768,
                max_submap_num=1, is_global_map=True)


def fixture_root(root=None) -> Path:
    """``root``, or the fixtures directory, created if missing."""
    root = Path(FIXTURE_DIR if root is None else root)
    root.mkdir(parents=True, exist_ok=True)
    return root


def write_whole(path: Path, save):
    """``save(f)`` into a temporary file beside ``path``, then rename it to
    ``path``."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        save(f)
    os.replace(tmp, path)


def seq_path(n_frames, root=None) -> Path:
    return fixture_root(root) / f"d435_synth_seq_{n_frames}.npz"


def map_path(n_frames, root=None) -> Path:
    return fixture_root(root) / f"ri_tsdf_equiv_{n_frames}.npy"


def ensure_sequence(n_frames=40, root=None) -> Path:
    """The ``n_frames`` orbit sequence's file, rendered if missing."""
    from taichislam_tpu_torch.utils.synthetic_scene import orbit_sequence
    path = seq_path(n_frames, root)
    if path.exists():
        return path
    print(f"[fixtures] rendering {n_frames}-frame D435-like sequence ...")
    depth, Rs, Ts, K = orbit_sequence(n_frames=n_frames)
    write_whole(path, lambda f: np.savez_compressed(f, depth=depth, Rs=Rs, Ts=Ts,
                                               K=K))
    print(f"[fixtures] wrote {path} ({path.stat().st_size / 1e6:.1f} MB)")
    return path


def ensure_map(n_frames=40, root=None, device=None) -> Path:
    """The saved global map of the ``n_frames`` sequence, fused on
    ``device`` (default: the CUDA card) if missing."""
    from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
    path = map_path(n_frames, root)
    if path.exists():
        return path
    with np.load(ensure_sequence(n_frames, root)) as z:
        depth, Rs, Ts, K = z["depth"], z["Rs"], z["Ts"], z["K"]
    print("[fixtures] fusing the sequence into a global TSDF map ...")
    m = DenseTSDF(**MAP_OPTS, device=device)
    m.set_dep_camera_intrinsic(K)
    for t in range(len(depth)):
        m.recast_depth_to_map(Rs[t], Ts[t], depth[t], None)
    write_whole(path, lambda f: np.save(f, m.export_submap()))
    print(f"[fixtures] wrote {path} ({path.stat().st_size / 1e6:.1f} MB, "
          f"{m.count_active()} voxels)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="fuse the map on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    from taichislam_tpu_torch.core.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else None)
    ensure_sequence(args.frames)
    ensure_map(args.frames, device=dev)


if __name__ == "__main__":
    main()
