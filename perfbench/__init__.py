"""The benchmark of the PyTorch and CUDA port, `mmlspark_tpu_torch`.

`python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or metric is a file found
by its name: configs/, workloads/, traffic/, metrics/, reference/.
"""
