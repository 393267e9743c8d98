"""Hand-written CUDA kernels of the segment pipeline, their plain
PyTorch versions (:mod:`.ref`) and the ops the pipeline calls."""
