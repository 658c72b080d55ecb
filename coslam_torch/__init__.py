"""coslam_torch: the Co-SLAM main path on PyTorch and CUDA.

A port of coslam_tpu (the JAX reference, which stays beside it) to
PyTorch, with the hash-grid and TensoVM encodes and their gradients as
hand-written CUDA kernels for Hopper (coslam_torch/csrc). The layout
mirrors coslam_tpu: ``ops/`` (encodings, render, losses, pose math, the
kernels' wrappers), ``models/`` (decoder, joint scene representation),
``runtime/`` (optimizers, tracking, keyframes, mapping, the sequential
SLAM loop, the pipelined tracker/mapper runtime, frame-tail
attribution), ``active/`` (ActiveCoSLAM: the beta head, info-gain
keyframes), ``mesh/`` (extraction and the native marching cubes),
``data/`` (dataset loaders; the analytic scenes, their protocols and
writers, and in-memory sequences), ``eval/`` (ATE, mesh culling,
reconstruction metrics, the benchmark protocol), ``config.py`` and
``tools/`` (the quality harness and its suite, virtual cameras, the
slices' profiler; ``bench/``, the scatter-accumulate probes). The port
keeps its own copy of every module it needs from coslam_tpu, even of those that import no jax: it
imports nothing of the JAX package.
"""

# Registers torch.ops.coslam_torch.grid_encode_fwd (kernel A as a PyTorch
# operator), which a program exported by tools/export.py names: import
# coslam_torch before torch.export.load.
from .ops import hash_packed as _hash_packed  # noqa: E402,F401

