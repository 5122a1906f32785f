"""``horovod_tpu_torch.parallel`` — the mesh-axis toolbox behind the
flagship model (port of horovod_tpu/parallel/):

* :mod:`.mesh` — ``DeviceMesh`` construction and the axis vocabulary
  (``DATA``/``FSDP``/``TENSOR``/``SEQUENCE``/``PIPELINE``/``EXPERT``).
* :mod:`.tensor_parallel` — Megatron column/row-parallel matmuls and the
  sequence-parallel gather/scatter pair.
* :mod:`.ring_attention` — exact ring attention over a sequence-sharded
  axis (the flash kernels or the plain blockwise ring), and unsharded
  attention; :mod:`.ulysses` — the all-to-all head-scatter alternative.
* :mod:`.pipeline` — GPipe and 1F1B microbatch schedules over a stage
  ring, and the bubble-fraction arithmetic.
* :mod:`.moe` — top-k token routing with capacity-bounded all-to-all
  dispatch/combine, the load-balancing aux loss, dropped-token
  accounting, and the optional int8/int4 dispatch wire (forward only).

As in the reference, the ``ring_attention`` function is not bound on the
package (it would shadow the submodule): reach it through the submodule.
``note_bubble`` is exported: it credits a pipeline span's bubble share to
the step-attribution engine (``metrics.attribution``).
"""

from . import mesh
from . import moe
from . import pipeline
from . import ring_attention
from . import tensor_parallel
from . import ulysses

from .mesh import (
    DATA, EXPERT, FSDP, PIPELINE, SEQUENCE, TENSOR,
    create_mesh, data_parallel_mesh, parse_mesh_spec,
)
from .moe import (
    MoEParams, MoEStats, RoutingInfo, dispatch_wire_bytes,
    expert_capacity, init_moe_params, moe_layer, moe_load_balancing_loss,
    top_k_routing,
)
from .pipeline import (
    Schedule1F1B, bubble_fraction, build_1f1b_schedule, note_bubble,
    pipeline_apply, pipeline_apply_1f1b, stack_microbatches,
    unstack_microbatches,
)
from .ring_attention import full_attention, reference_attention
from .tensor_parallel import (
    column_parallel, gather_sequence, row_parallel,
    vocab_parallel_cross_entropy, vocab_parallel_logits,
)
from .ulysses import ulysses_attention

__all__ = [
    "mesh", "moe", "pipeline", "ring_attention", "tensor_parallel",
    "ulysses",
    "DATA", "EXPERT", "FSDP", "PIPELINE", "SEQUENCE", "TENSOR",
    "create_mesh", "data_parallel_mesh", "parse_mesh_spec",
    "MoEParams", "MoEStats", "RoutingInfo", "dispatch_wire_bytes",
    "expert_capacity", "init_moe_params", "moe_layer",
    "moe_load_balancing_loss", "top_k_routing",
    "Schedule1F1B", "bubble_fraction", "build_1f1b_schedule",
    "note_bubble", "pipeline_apply", "pipeline_apply_1f1b",
    "stack_microbatches", "unstack_microbatches",
    "full_attention", "reference_attention",
    "column_parallel", "gather_sequence", "row_parallel",
    "vocab_parallel_cross_entropy", "vocab_parallel_logits",
    "ulysses_attention",
]
