"""Topology-skeleton worker process.

Counterpart of the JAX package's ``node/topo_worker.py``: a separate OS process
that receives the exported global map through a ``multiprocessing.Manager``
dict, loads it into its own DenseTSDF, regenerates the skeleton graph and
posts the edge list back for rendering.

Unlike the JAX worker, which pins itself to the CPU because one process
owns a TPU, this one takes a ``device`` (the CUDA card by default): several
processes can share an H100. CUDA cannot be initialised in a forked child,
so start :func:`TopoGenThread` with a ``spawn`` context.
"""

import time

import numpy as np


class TopoGen:
    def __init__(self, params_map, params_topo, man_d, device=None):
        from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF
        from taichislam_tpu_torch.models.topo_graph import TopoGraphGen

        self.mapping = DenseTSDF(is_global_map=True, device=device,
                                 **params_map)
        self.topo = TopoGraphGen(self.mapping, **params_topo)
        self.man_d = man_d

    def run(self):
        print("Start topo graph generation thread")
        while not self.man_d["exit"]:
            try:
                if self.man_d["update"]:
                    self.loadMap(self.man_d["map_data"])
                    self.gen_skeleton_graph()
                    self.man_d["update"] = False
                time.sleep(1)
            except Exception as e:
                print(e)
                break

    def loadMap(self, map_data):
        self.mapping.reset()
        self.mapping.load_numpy(0, map_data["indices"], map_data["TSDF"],
                                map_data["W_TSDF"], map_data["occupy"],
                                map_data["color"])

    def gen_skeleton_graph(self):
        start_pt = np.array(self.man_d.get("start_pt", [1.0, 0.0, 0.5]))
        self.topo.reset()
        s = time.time()
        num_nodes = self.topo.generate_topo_graph(start_pt, max_nodes=100000)
        print(f"[Topo] Number of polygons: {num_nodes} start pt {start_pt} "
              f"t: {(time.time()-s)*1000:.1f}ms")
        self.export_topo_graph()

    def export_topo_graph(self):
        lines = np.asarray(self.topo.edges, np.float32).reshape(-1, 3) \
            if self.topo.edges else np.zeros((0, 3), np.float32)
        self.man_d["topo_graph_viz"] = {"lines": lines}


def TopoGenThread(params, man_d):
    """Process entry: ``params`` holds ``sdf_params`` and
    ``skeleton_graph_gen_opts`` and, optionally, ``device`` (the card when
    absent). On the card start it with
    ``multiprocessing.get_context("spawn").Process``."""
    print("TopoGenThread: params = ", params)
    topo = TopoGen(params["sdf_params"], params["skeleton_graph_gen_opts"],
                   man_d, device=params.get("device"))
    topo.run()
