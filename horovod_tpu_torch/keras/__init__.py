"""The Keras front end on the port (port of horovod_tpu/keras/): the
TensorFlow front end's calls and ``DistributedOptimizer``, the callbacks
(``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback``, ``LearningRateScheduleCallback``,
``MetricsCallback``, and the elastic ``CommitStateCallback`` /
``UpdateEpochStateCallback``) and ``KerasState``.  It runs on the CPU,
as the TensorFlow front end does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import tensorflow as _tf

from ..tensorflow import (init, shutdown, rank, size, local_rank,
                          local_size, allreduce, allgather, broadcast,
                          broadcast_variables, DistributedOptimizer,
                          Average, Sum, Adasum, Compression)
from . import callbacks  # noqa: F401  (re-export module)
from . import elastic  # noqa: F401  (KerasState + commit callbacks)
