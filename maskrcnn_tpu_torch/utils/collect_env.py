"""Environment report logged by train_net and test_net (port of
maskrcnn_tpu/utils/collect_env.py): the platform, Python, NumPy, PyTorch
and its CUDA and cuDNN builds, the visible devices, and ``nvcc --version``
when nvcc is found (CUDA_HOME, /usr/local/cuda or the PATH)."""

import platform
import subprocess
import sys

import numpy
import torch


def _nvcc_version():
    from ..ops.native import nvcc_path

    try:
        nvcc = nvcc_path()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return "not found"
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    return "{} ({})".format(lines[-1] if lines else "?", nvcc)


def collect_env_info():
    lines = [
        "sys.platform: {}".format(sys.platform),
        "Python: {}".format(sys.version.replace("\n", "")),
        "Machine: {}".format(platform.machine()),
        "NumPy: {}".format(numpy.__version__),
        "PyTorch: {}".format(torch.__version__),
        "PyTorch CUDA: {}".format(torch.version.cuda),
        "cuDNN: {}".format(torch.backends.cudnn.version()
                           if torch.backends.cudnn.is_available() else None),
    ]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(n)]
        lines.append("Devices: {} x {}".format(n, ", ".join(sorted(set(names)))))
    else:
        lines.append("Devices: none (CPU only)")
    lines.append("nvcc: {}".format(_nvcc_version()))
    return "\n".join(lines)
