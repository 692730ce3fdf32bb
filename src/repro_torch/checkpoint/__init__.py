"""Sharded checkpoints with a quorum-committed cut (port of
``repro.checkpoint``)."""
