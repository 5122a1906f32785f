"""horovod_tpu_torch's package boundary: it imports neither JAX nor
horovod_tpu, its entry points refuse to run quietly on the CPU, and the
chip smoke test refuses to report without a GPU or without the package."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "horovod_tpu_torch")
NO_GPU = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _run(code, env=None, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now fails
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch import convert, optimizers\n"
        "from horovod_tpu_torch.models import transformer\n"
        "from horovod_tpu_torch.core import config, handles\n"
        "from horovod_tpu_torch.ops import _build, collective, compression, "
        "flash_attention, quantization\n"
        "from horovod_tpu_torch.parallel import ring_attention\n"
        "from horovod_tpu_torch.parallel import mesh, ulysses\n"
        "from horovod_tpu_torch.ops import gspmd, xla_collectives\n"
        "from horovod_tpu_torch import parallel\n"
        "assert horovod_tpu_torch.mesh is horovod_tpu_torch.core.basics"
        ".mesh\n"
        "from horovod_tpu_torch import checkpoint, data\n"
        "from horovod_tpu_torch.checkpoint import engine, zero\n"
        "from horovod_tpu_torch.utils import checkpoint as utils_ckpt\n"
        "bad = [m for m in sys.modules if m == 'horovod_tpu' or "
        "m.startswith('horovod_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax_or_reference(path):
    banned = re.compile(r"^\s*(import|from)\s+(jax|horovod_tpu)(\.|\s|$)",
                        re.M)
    with open(path) as f:
        assert not banned.search(f.read()), path


@pytest.mark.parametrize("module", [
    "horovod_tpu_torch.parallel.mesh", "horovod_tpu_torch.parallel.ulysses",
    "horovod_tpu_torch.parallel.ring_attention",
    "horovod_tpu_torch.ops.gspmd", "horovod_tpu_torch.ops.xla_collectives",
    "horovod_tpu_torch.parallel.tensor_parallel",
    "horovod_tpu_torch.parallel.moe", "horovod_tpu_torch.parallel.pipeline",
    "horovod_tpu_torch.models.transformer",
    "horovod_tpu_torch.models.mlp", "horovod_tpu_torch.models.resnet",
    "horovod_tpu_torch.models.bert",
    "horovod_tpu_torch.models.moe_transformer",
    "horovod_tpu_torch.runner.rendezvous", "horovod_tpu_torch.serving",
    "horovod_tpu_torch.serving.policy", "horovod_tpu_torch.serving.prefix",
    "horovod_tpu_torch.serving.speculative",
    "horovod_tpu_torch.serving.tracing", "horovod_tpu_torch.serving.engine",
    "horovod_tpu_torch.serving.loadgen", "horovod_tpu_torch.serving.slo",
    "horovod_tpu_torch.serving.server", "horovod_tpu_torch.serving.submit",
    "horovod_tpu_torch.serving.service",
    "horovod_tpu_torch.serving.disagg", "horovod_tpu_torch.serving.autoscale",
    "horovod_tpu_torch.metrics", "horovod_tpu_torch.metrics.registry",
    "horovod_tpu_torch.metrics.exporters",
    "horovod_tpu_torch.metrics.attribution",
    "horovod_tpu_torch.metrics.digest", "horovod_tpu_torch.metrics.health",
    "horovod_tpu_torch.metrics.baseline",
    "horovod_tpu_torch.metrics.aggregate",
    "horovod_tpu_torch.metrics.observer", "horovod_tpu_torch.debug",
    "horovod_tpu_torch.debug.flight", "horovod_tpu_torch.debug.http",
    "horovod_tpu_torch.debug.hang", "horovod_tpu_torch.debug.regression",
    "horovod_tpu_torch.debug.merge", "horovod_tpu_torch.utils.logging",
    "horovod_tpu_torch.utils.profiler",
    "horovod_tpu_torch.net", "horovod_tpu_torch.net.retry",
    "horovod_tpu_torch.net.chaos", "horovod_tpu_torch.net.native",
    "horovod_tpu_torch.recovery", "horovod_tpu_torch.recovery.buddy",
    "horovod_tpu_torch.recovery.chaos", "horovod_tpu_torch.recovery.store",
    "horovod_tpu_torch.recovery.transport",
    "horovod_tpu_torch.recovery.peer",
    "horovod_tpu_torch.elastic", "horovod_tpu_torch.elastic.state",
    "horovod_tpu_torch.runner.hosts", "horovod_tpu_torch.runner.chips",
    "horovod_tpu_torch.runner.exec", "horovod_tpu_torch.runner.worker",
    "horovod_tpu_torch.runner.elastic_driver",
    "horovod_tpu_torch.core.failure", "horovod_tpu_torch.runner",
    "horovod_tpu_torch.runner.launch", "horovod_tpu_torch.runner.bootstrap",
    "horovod_tpu_torch.runner.probe",
    "horovod_tpu_torch.runner.gpu_discovery",
    "horovod_tpu_torch.runner.fnpickle",
    "horovod_tpu_torch.runner.fn_exec", "horovod_tpu_torch.autotune",
    "horovod_tpu_torch.fleet", "horovod_tpu_torch.fleet.tuning",
    "horovod_tpu_torch.fleet.job", "horovod_tpu_torch.fleet.queue",
    "horovod_tpu_torch.fleet.policy", "horovod_tpu_torch.fleet.scheduler",
    "horovod_tpu_torch.fleet.gateway", "horovod_tpu_torch.fleet.client",
    "horovod_tpu_torch.fleet.observe", "horovod_tpu_torch.fleet.submit",
    "horovod_tpu_torch.torch", "horovod_tpu_torch.torch.elastic",
    "horovod_tpu_torch.torch.sync_batch_norm", "horovod_tpu_torch.mxnet",
    "horovod_tpu_torch.spark", "horovod_tpu_torch.spark.store",
    "horovod_tpu_torch.spark.estimator",
    "horovod_tpu_torch.spark.elastic_exec", "horovod_tpu_torch.ray"])
def test_mesh_gspmd_and_sequence_modules_import_without_jax(module):
    """Each module of the mesh, the GSPMD plane, sequence parallelism,
    the models, the serving plane, the telemetry plane, the wire fabric,
    the recovery tier, elastic training, the tuner, the fleet service,
    the torch and mxnet front ends and the cluster integrations,
    imported first in a fresh interpreter where ``import jax`` fails (and
    ``import tensorflow``, ``import pyspark`` and ``import ray``)."""
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tensorflow'] = None\n"
            "sys.modules['pyspark'] = None\n"
            "sys.modules['ray'] = None\n"
            f"importlib.import_module({module!r})\n"
            "bad = [m for m in sys.modules if m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.') or m == 'jax']\n"
            "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_tensorflow_and_keras_front_ends_import_without_jax():
    """The TensorFlow and Keras front ends (and the Keras alias) import
    with TensorFlow where ``import jax`` fails, and bring in nothing of
    horovod_tpu."""
    pytest.importorskip("tensorflow")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import horovod_tpu_torch.tensorflow as t\n"
            "import horovod_tpu_torch.keras as k\n"
            "import horovod_tpu_torch.tensorflow.keras as tk\n"
            "from horovod_tpu_torch.keras import callbacks, elastic\n"
            "from horovod_tpu_torch.tensorflow import elastic as te\n"
            "assert tk.DistributedOptimizer is k.DistributedOptimizer\n"
            "bad = [m for m in sys.modules if m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.') or m == 'jax']\n"
            "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


TF_OPS_MARKS = ("// port: op names of its own",)


def test_tf_custom_op_source_is_the_reference_copy():
    """The port's TF custom op is the reference's source line for line,
    but for the lines marked ``// port:``, which only rename the ops (so
    both libraries can load into one process)."""
    with open(os.path.join(ROOT, "horovod_tpu", "tensorflow", "ops",
                           "hvd_tf_ops.cc")) as f:
        ref = f.read().splitlines()
    with open(os.path.join(PKG, "tensorflow", "ops", "hvd_tf_ops.cc")) as f:
        port = f.read().splitlines()
    assert len(port) == len(ref)
    changed = [(p, r) for p, r in zip(port, ref) if p != r]
    assert changed
    for p, r in changed:
        assert any(p.endswith("  " + m) for m in TF_OPS_MARKS), p
        assert p.split("  // port:")[0].replace(
            '"HvdTpuTorch', '"HvdTpu') == r
    assert os.listdir(os.path.join(PKG, "tensorflow", "ops")) == \
        ["hvd_tf_ops.cc"]


def test_native_builds_and_imports_without_jax():
    """The native runtime, its controller and the negotiated plane's
    modules import, build and load in an interpreter where ``import jax``
    fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from horovod_tpu_torch.native import _build, controller, "
            "runtime\n"
            "from horovod_tpu_torch.ops import dispatch, eager\n"
            "assert _build.build().startswith(_build.BUILD_DIR)\n"
            "controller.load_library()\n"
            "bad = [m for m in sys.modules if m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.') or m == 'jax']\n"
            "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_init_refuses_cpu_fallback():
    proc = _run("import horovod_tpu_torch as h\nh.init()", env=NO_GPU)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_init_world_one_on_cpu():
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    hvd.init(device="cpu")
    try:
        hvd.init(device="cpu")  # idempotent
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.device() == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()
    assert not torch.distributed.is_initialized()


def test_chip_smoke_refuses_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=NO_GPU, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "missing"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_is_keyed_by_source_and_flags():
    path = _build.library_path(os.path.join(_build.CSRC,
                                            "flash_attention.cu"))
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert re.fullmatch(r"libflash_attention-[0-9a-f]{16}\.so",
                        os.path.basename(path))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_resolve_device():
    from horovod_tpu_torch.core.basics import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
