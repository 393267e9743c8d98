"""The LM stack's models (port of ``repro/models``): layers (with MoE),
the Mamba and RWKV-6 mixers, and the decoder assembled from an
ArchConfig."""
