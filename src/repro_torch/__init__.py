"""PyTorch/CUDA port of the track-processing system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and imports nothing of it.  The track
workflow's process phase runs on an NVIDIA Hopper card through three
hand-written CUDA kernels (:mod:`repro_torch.kernels`); entry points
run on the card unless the caller asks for the CPU.
"""
