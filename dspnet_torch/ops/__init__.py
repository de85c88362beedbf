"""ops (dspnet_torch).

Importing the package registers the operator ``dspnet::nms_keep_mask``
(``ops/nms_cuda.py``), which a program exported by
``tools/export_serving.py`` calls; nothing is built until it first runs on
a card.
"""

from dspnet_torch.ops import nms_cuda  # noqa: F401  (registers dspnet::nms_keep_mask)
