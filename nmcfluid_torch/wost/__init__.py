"""Walk-on-stars pressure estimator (generation executor)."""
