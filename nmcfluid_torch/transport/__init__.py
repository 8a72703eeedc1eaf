"""The Taylor-Green velocity error metric."""
