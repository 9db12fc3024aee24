"""Matmul precision policy for the geometry pipeline.

Every contraction in this engine is geometry with a tiny inner dimension
(K = 3..6: point transforms, distance matrices, normal equations), where
reduced-precision matmul inputs cost accuracy and buy nothing: the JAX
package measured a 7x trajectory-error increase from bf16 MXU inputs (see
``lego_loam_tpu/utils/precision.py``).  On NVIDIA cards the counterpart is
TF32, which keeps ~10 mantissa bits; it is switched off for both matmuls
and cuDNN, once, when a pipeline is built.
"""

from __future__ import annotations

import torch


def apply_f32_policy() -> None:
    """Full-float32 matmuls and convolutions (TF32 off everywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
