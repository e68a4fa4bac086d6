"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch and NumPy, float32 or float64 with TF32 off; nothing here
imports jax, the JAX package or the PyTorch port (a test checks it).
"""
