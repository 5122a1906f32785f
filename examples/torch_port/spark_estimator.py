"""Estimator API on the port: fit a DataFrame, get a transformer back
(the counterpart of examples/spark_estimator.py).

Works on plain pandas DataFrames (Spark DataFrames are accepted too when
pyspark is installed: they are materialized through the same Store).
The fit computes on the card (``--num-proc`` ranks through
``runner.run``, one card each), or on the CPU over gloo with ``--device
cpu``.

    python examples/torch_port/spark_estimator.py --num-proc 2
    python examples/torch_port/spark_estimator.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch.spark as hvd_spark  # noqa: E402


def synthetic_frame(rows, seed=0):
    """``features`` (4 floats a row) and a noisy linear ``label``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 4).astype(np.float32)
    w = np.array([0.5, -1.0, 2.0, 0.25], dtype=np.float32)
    return pd.DataFrame({
        "features": [row.tolist() for row in x],
        "label": (x @ w + 0.05 * rng.randn(rows)).astype(np.float32),
    })


def estimator(store, epochs=20, batch=64, num_proc=1, device=None):
    """A ``TorchEstimator`` of a seeded ``Linear(4, 1)`` on ``store``."""
    torch.manual_seed(0)
    return hvd_spark.TorchEstimator(
        model=torch.nn.Linear(4, 1), lr=0.05, epochs=epochs,
        batch_size=batch, num_proc=num_proc, validation=0.2, store=store,
        device=device, feature_cols=["features"], label_cols=["label"])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=512)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num-proc", type=int, default=1,
                   help="data-parallel ranks (local processes)")
    p.add_argument("--device", default=None,
                   help="cpu to compute on the CPU over gloo")
    args = p.parse_args()

    df = synthetic_frame(args.rows)
    with tempfile.TemporaryDirectory(prefix="hvd_store_") as root:
        store = hvd_spark.Store.create(root)
        est = estimator(store, args.epochs, args.batch, args.num_proc,
                        args.device)
        model = est.fit(df)
        print("validation loss:", model.validation_loss)
        out = model.transform(df)
        mse = float(np.mean((out["label__output"] - df["label"]) ** 2))
        print("train MSE:", round(mse, 5))
        print("checkpoint:", len(store.load_checkpoint(est.run_id)),
              "bytes")


if __name__ == "__main__":
    main()
