"""The benchmark of the PyTorch and CUDA port: `run.py` runs one cell.

Everything a cell needs is found by name from BENCHMARK.json: its
configuration in `configs/`, its traffic mix in `traffic/`, each metric's
reader in `metrics/`. `ref/` is the plain reference that decides
`correct`; `program.py` is the only module that imports the port.
"""
