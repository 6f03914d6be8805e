"""``mx.sym.contrib``: the contrib ops as graph nodes.

Counterpart of ``mxnet_tpu/symbol/contrib.py`` (reference:
python/mxnet/symbol/contrib.py): the JAX package's list of contrib names,
each one the port's registry has, under its canonical name and aliases
(``MultiBoxPrior``, ``_contrib_MultiBoxPrior``, ``multibox_prior``).
Symbolic control flow (``foreach``, ``while_loop``, ``cond``) is not
ported.
"""

from __future__ import annotations

from ..ops import registry as _reg
from .register import populate as _populate

_CONTRIB_OPS = [
    "box_nms", "box_iou", "MultiBoxPrior", "MultiBoxTarget",
    "MultiBoxDetection", "ROIAlign", "BilinearResize2D",
    "AdaptiveAvgPooling2D", "boolean_mask", "quadratic",
    "arange_like", "getnnz", "index_copy", "index_add",
    "adamw_update", "_contrib_flash_attention", "_contrib_div_sqrt_dim",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
]

_populate(globals(), names=[n for n in _CONTRIB_OPS if n in _reg.list_ops()])
