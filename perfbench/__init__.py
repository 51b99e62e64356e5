"""The benchmark of the PyTorch and CUDA port (``gym_formation_tpu_torch``)
on an NVIDIA H100: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``harness`` for how a cell is found."""
