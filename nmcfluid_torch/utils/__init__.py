"""Random keys, checkpoints, visualization and the CUDA build."""
