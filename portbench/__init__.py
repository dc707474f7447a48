"""The benchmark of the PyTorch/CUDA port ``fusion_cryptography_tpu_torch``
(``python3 portbench/run.py``; the manifest is ``BENCHMARK.json``)."""
