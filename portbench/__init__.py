"""The benchmark of exciting_environments_torch, the PyTorch and CUDA port:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (see ``README.md``)."""
