#!/usr/bin/env python
"""Install maskrcnn_tpu and build the native host ops.

The TPU compute kernels are JAX/Pallas (no build step); the optional native
library (csrc/maskops.cpp — polygon rasterizer, RLE, NMS golden) is built
as a plain shared object loaded via ctypes (no pybind11 dependency).
"""

import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        try:
            subprocess.run(["make", "-C", "csrc"], check=True)
        except Exception as e:  # noqa: BLE001
            print("warning: native maskops build failed ({}); "
                  "numpy fallbacks will be used".format(e))
        super().run()


setup(
    name="maskrcnn_tpu",
    version="0.1.0",
    description=(
        "TPU-native object detection & instance segmentation "
        "(Faster/Mask/Keypoint R-CNN, RetinaNet) in JAX/XLA/Pallas"
    ),
    packages=find_packages(exclude=("tests", "tools", "demo")),
    # the PyTorch port's CUDA and host C++ sources, compiled at first use
    package_data={"maskrcnn_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pyyaml", "optax"],
    cmdclass={"build_py": BuildWithNative},
)
