"""lego_loam_tpu_torch: the LeGO-LOAM engine on PyTorch and CUDA.

A port of ``lego_loam_tpu`` (JAX/XLA/Pallas) that keeps its module layout
and names.  Plain tensor code is PyTorch; the three Pallas TPU kernels of
the scan-to-map main path are hand-written CUDA C++ for Hopper
(``csrc/``), and so is the 6x6 eigen-solve that keeps the host from
waiting on cuSOLVER (``csrc/eig6.cu``), all built with nvcc at first use
and bound with ctypes (``kernels/``).  Every kernel wrapper runs its plain PyTorch version for a
CPU tensor and its kernel for a CUDA tensor.

The package imports torch and numpy only -- never jax, never
``lego_loam_tpu``.
"""

from lego_loam_tpu_torch.config import (  # noqa: F401
    DEFAULT_CONFIG,
    HDL32E,
    HDL64E,
    OS1_16,
    OS1_64,
    PipelineConfig,
    SENSOR_PRESETS,
    SensorSpec,
    VLP16,
    VLS128,
    config_for,
)
from lego_loam_tpu_torch.utils.math3d import Pose  # noqa: F401

__version__ = "0.1.0"
