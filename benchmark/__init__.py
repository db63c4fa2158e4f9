"""The benchmark of the PyTorch and CUDA port (``gpquad_torch``); run one
cell with ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
