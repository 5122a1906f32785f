"""Alias module: ``horovod_tpu_torch.tensorflow.keras`` ==
``horovod_tpu_torch.keras``.

The reference exposes its Keras front-end under both ``horovod.keras`` and
``horovod.tensorflow.keras`` (horovod/tensorflow/keras/__init__.py); users
migrating scripts expect either import path to work.
"""

from ..keras import *            # noqa: F401,F403
from ..keras import callbacks    # noqa: F401
