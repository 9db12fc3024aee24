"""Benchmark of the PyTorch/CUDA port (lego_loam_tpu_torch): fleet replay
through models/batch.BatchPipeline on one card.  Run a cell with
``python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root."""
