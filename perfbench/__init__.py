"""The benchmark of the PyTorch port (``arkoserenderer_torch``): one command,
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``, driven by ``BENCHMARK.json`` and the files under this folder."""
