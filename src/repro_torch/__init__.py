"""PyTorch/CUDA port of the track-processing system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module and imports nothing of it.  The track
workflow's process and screen phases and the dense LM's forward and
serving path run on an NVIDIA Hopper card through five hand-written
CUDA kernels (:mod:`repro_torch.kernels`); entry points run on the card
unless the caller asks for the CPU.
"""
