"""The benchmark of the PyTorch and CUDA port (``repro_torch``): QuAFL
rounds of the paper's MLP and of a decoder LM on one H100, driven by the
data files under this folder. ``python perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
