"""The port's ``tensor`` package (``bigdl_tpu/tensor``): the BigDL
``Tensor`` facade and the COO ``SparseTensor``."""

from bigdl_tpu_torch.tensor.sparse import SparseTensor
from bigdl_tpu_torch.tensor.tensor import Tensor

__all__ = ["Tensor", "SparseTensor"]
