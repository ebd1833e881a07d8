"""Checkpoints (port of ``repro.checkpoint``): ``manager.CheckpointManager``
writes and reads the reference's on-disk format."""
