"""The benchmark of the PyTorch and CUDA port (`pidnet_tpu_torch`) on an
NVIDIA H100: `python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (README.md)."""
