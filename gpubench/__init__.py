"""The benchmark of the PyTorch and CUDA port (word2vec_tpu_torch).

Driven by BENCHMARK.json at the root of the checkout; run.py says how a
run goes, manifest.py how its files are found. Nothing here imports jax or
the JAX package, and reference/ imports nothing of the port.
"""
