"""Small, CPU-sized runs of the benchmark's cells for the tests."""

import torch

# a 160 x 120 corner of the camera, 30 distinct frames, a short warm-up
TINY = {"height": 120, "width": 160, "distinct_frames": 30,
        "warmup_frames": 3, "check_frames": 1}
TINY_SUBMAP = dict(TINY, warmup_frames=12)
CELLS = {"d435_submap_tsdf.orbit30": TINY_SUBMAP,
         "node_esdf_textured.orbit_backlog": TINY}


def tiny_run(name, seed=2147483659, seconds=1.0, **kw):
    from benchmark.cells import Cell
    from benchmark.harness import run_cell
    return run_cell(Cell(name), seed, seconds, False, torch.device("cpu"),
                    frames_override=CELLS[name], **kw)
