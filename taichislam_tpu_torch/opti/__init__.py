from taichislam_tpu_torch.opti import transformations  # noqa: F401
from taichislam_tpu_torch.opti.nnls import (CostFunction, NNLS,  # noqa: F401
                                            TaichiNNLS)
