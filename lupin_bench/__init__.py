"""The benchmark of the PyTorch/CUDA port (`lupinpathtracer_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; README.md says how.
"""
