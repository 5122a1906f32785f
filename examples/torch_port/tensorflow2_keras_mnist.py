"""TF2/Keras data-parallel training on the port's Keras front end (the
counterpart of examples/tensorflow2_keras_mnist.py), on synthetic
MNIST-shaped data.  TensorFlow computes on the CPU; the world is gloo.

    hvdrun-torch -np 2 --worker-platform cpu \
        python examples/torch_port/tensorflow2_keras_mnist.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import tensorflow as tf  # noqa: E402

import horovod_tpu_torch.keras as hvd  # noqa: E402
from horovod_tpu_torch.keras.callbacks import (  # noqa: E402
    BroadcastGlobalVariablesCallback, LearningRateWarmupCallback,
    MetricAverageCallback)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--samples", type=int, default=1024)
    args = p.parse_args()

    hvd.init()
    np.random.seed(hvd.rank())
    x = np.random.randn(args.samples, 784).astype(np.float32)
    y = np.random.randint(0, 10, (args.samples,))

    model = tf.keras.Sequential([
        tf.keras.Input(shape=(784,)),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(10),
    ])
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.01 * hvd.size()))
    model.compile(optimizer=opt, loss=tf.keras.losses.
                  SparseCategoricalCrossentropy(from_logits=True),
                  metrics=["accuracy"])
    model.fit(x, y, batch_size=64, epochs=args.epochs,
              verbose=2 if hvd.rank() == 0 else 0,
              callbacks=[BroadcastGlobalVariablesCallback(0),
                         MetricAverageCallback(),
                         LearningRateWarmupCallback(
                             initial_lr=0.01 * hvd.size(),
                             warmup_epochs=1)])
    hvd.shutdown()


if __name__ == "__main__":
    main()
