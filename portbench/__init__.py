"""The benchmark of knode_cosserat_tpu_torch (the PyTorch and CUDA port):
``run.py`` runs one cell of ``BENCHMARK.json`` once."""
