"""Training runtime: optimizer, schedules, compression, checkpointing,
trainer (port of ``repro/train``)."""
