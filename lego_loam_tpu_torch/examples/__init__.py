"""The user entry points of the port, one module for each driver of the
JAX package's ``examples/`` (run_synthetic, run_kitti, run_rosbag, soak):

    python -m lego_loam_tpu_torch.examples.<name> [flags]

Each takes the JAX script's own flags, runs on the card, and with
``--cpu`` on the CPU (the kernels' plain versions).  Without a card and
without ``--cpu`` a runner exits non-zero; it never falls back to the CPU.
Each module's ``run(...)`` takes the config, the course or input and the
device, and returns what the script prints."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """`device` as a torch.device.  A CUDA device without a card ends the
    run with a message (SystemExit): there is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: this runner runs on "
                         "the card; pass --cpu to run it on the CPU")
    return dev

