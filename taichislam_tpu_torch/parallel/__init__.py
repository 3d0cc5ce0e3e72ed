from taichislam_tpu_torch.parallel import multi_drone  # noqa: F401
from taichislam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
