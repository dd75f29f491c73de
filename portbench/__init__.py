"""portbench: the benchmark of the PyTorch and CUDA port on one H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; see README.md.
"""
