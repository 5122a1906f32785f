"""Synthetic TF2 training benchmark on the port's TensorFlow front end
(the counterpart of examples/tensorflow2_synthetic_benchmark.py): timed
batches with the gradients reduced through ``DistributedGradientTape``.
TensorFlow computes on the CPU; the world is gloo.

    hvdrun-torch -np 2 --worker-platform cpu \
        python examples/torch_port/tensorflow2_synthetic_benchmark.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import tensorflow as tf  # noqa: E402

import horovod_tpu_torch.tensorflow as hvd  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    args = p.parse_args()

    hvd.init()
    tf.random.set_seed(1234 + hvd.rank())

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(32, 3, strides=2, activation="relu"),
        tf.keras.layers.Conv2D(64, 3, strides=2, activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(1000),
    ])
    opt = tf.keras.optimizers.SGD(0.01)
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True)

    data = tf.random.normal(
        (args.batch_size, args.image_size, args.image_size, 3))
    target = tf.random.uniform((args.batch_size,), 0, 1000, tf.int64)

    first = {"done": False}

    def benchmark_step():
        with tf.GradientTape() as tape:
            loss = loss_fn(target, model(data, training=True))
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if not first["done"]:
            # Broadcast once the variables exist (after the first step).
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
            first["done"] = True

    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        rate = args.batch_size * args.num_batches_per_iter / \
            (time.perf_counter() - t0)
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"iter {i}: {rate:.1f} img/sec per worker")

    if hvd.rank() == 0:
        avg = sum(img_secs) / len(img_secs)
        print(f"img/sec per worker: {avg:.1f}")
        print(f"total img/sec on {hvd.size()} worker(s): "
              f"{avg * hvd.size():.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
