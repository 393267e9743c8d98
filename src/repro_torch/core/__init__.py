"""Paper core: triples-mode launch and the self-scheduling task model."""
