"""The scatter-accumulate probes on the card (counterparts of the Pallas
probes of tools/bench/, K5-K12), each run as

    python -m coslam_torch.tools.bench.<name> [--quick]

at the JAX probe's own shapes, printing its lines (ms, M upd/s, parity
error) for the kernels of coslam_torch/ops/probe_accum.py. ``--quick``
runs one setting per kernel. Each needs a CUDA card; its ``check``
function runs every variant once against the plain versions, on any
device, at the probe's shapes or (``small``) at a few thousand updates.
"""
