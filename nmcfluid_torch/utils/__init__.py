"""Random keys and checkpoints."""
