"""Keras elastic surface of the port (reference horovod/_keras/elastic.py):
KerasState is the TF-Keras model/optimizer state object; the commit/epoch
callbacks live in keras.callbacks."""

from ..tensorflow.elastic import (TensorFlowKerasState as KerasState,  # noqa: F401
                                  run)
from .callbacks import (CommitStateCallback,  # noqa: F401
                        UpdateEpochStateCallback)

__all__ = ["KerasState", "run", "CommitStateCallback",
           "UpdateEpochStateCallback"]
