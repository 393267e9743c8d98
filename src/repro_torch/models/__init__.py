"""The LM stack's models (port of ``repro/models``): layers and the
decoder assembled from an ArchConfig."""
