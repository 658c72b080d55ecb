"""coslam_torch: the Co-SLAM main path on PyTorch and CUDA.

A port of coslam_tpu (the JAX reference, which stays beside it) to
PyTorch, with the hash-grid and TensoVM encodes and their gradients as
hand-written CUDA kernels for Hopper (coslam_torch/csrc). The layout
mirrors coslam_tpu: ``ops/`` (encodings, render, losses, pose math, the
kernels' wrappers), ``models/`` (decoder, joint scene representation),
``runtime/`` (optimizers, tracking, keyframes, mapping, the sequential
SLAM loop), ``mesh/``, ``data/`` (in-memory synthetic sequences) and
``tools/`` (the slices' profiler). Framework-neutral modules of coslam_tpu (datasets, synthetic
scenes, rays, marching cubes, ATE, config) are imported, not copied;
none of them imports jax.
"""
