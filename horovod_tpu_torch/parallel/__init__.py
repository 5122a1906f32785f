"""``horovod_tpu_torch.parallel`` — the mesh and sequence parallelism
(port of horovod_tpu/parallel/, the parts ported so far):

* :mod:`.mesh` — ``DeviceMesh`` construction and the axis vocabulary
  (``DATA``/``FSDP``/``TENSOR``/``SEQUENCE``/``PIPELINE``/``EXPERT``).
* :mod:`.ring_attention` — exact ring attention over a sequence-sharded
  axis (the flash kernels or the plain blockwise ring), and unsharded
  attention; :mod:`.ulysses` — the all-to-all head-scatter alternative.

As in the reference, the ``ring_attention`` function is not bound on the
package (it would shadow the submodule): reach it through the submodule.
"""

from . import mesh
from . import ring_attention
from . import ulysses

from .mesh import (
    DATA, EXPERT, FSDP, PIPELINE, SEQUENCE, TENSOR,
    create_mesh, data_parallel_mesh, parse_mesh_spec,
)
from .ring_attention import full_attention, reference_attention
from .ulysses import ulysses_attention

__all__ = [
    "mesh", "ring_attention", "ulysses",
    "DATA", "EXPERT", "FSDP", "PIPELINE", "SEQUENCE", "TENSOR",
    "create_mesh", "data_parallel_mesh", "parse_mesh_spec",
    "full_attention", "reference_attention", "ulysses_attention",
]
