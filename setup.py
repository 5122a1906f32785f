"""Package build: compiles the native runtime and installs `hvdrun`.

(The reference drives a CMake superbuild from setup.py — setup.py:29-199;
this runtime is small enough for a make-based extension step.)
"""

import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "horovod_tpu", "native", "src")
        subprocess.run(["make", "-C", src], check=True)
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework with the "
                 "capability set of Horovod"),
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    # horovod_tpu_torch (the PyTorch/CUDA port) builds its kernels from
    # csrc/*.cu with nvcc at first use, so the sources ship as data.
    package_data={"horovod_tpu.native": ["libhvdtpu_core.so"],
                  "horovod_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "optax", "cloudpickle"],
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.runner.launch:main",
        ],
    },
    cmdclass={"build_py": BuildWithNative},
)
