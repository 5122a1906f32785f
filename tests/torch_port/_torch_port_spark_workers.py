"""The reference's estimator worker for the two-rank parity test of
test_torch_port_spark_estimator.py, run by the reference's
``runner.run``: its ``_torch_fit_worker`` on a spec that crosses as
pickled bytes, so each rank trains its own copy of the model.  (Handed
to a spawned process as an argument, the model's tensors would move to
shared memory, and both ranks would step one set of parameters.)"""

import pickle


def ref_fit_from_bytes(spec_bytes):
    from horovod_tpu.spark.estimator import _torch_fit_worker
    return _torch_fit_worker(pickle.loads(spec_bytes))
