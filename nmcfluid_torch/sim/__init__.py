"""The operator-split fluid stepper and its fused phase-fit kernel."""
