"""Columnar track store: only the ``store://`` URI grammar so far."""
