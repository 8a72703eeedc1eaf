"""SIREN velocity fields and per-scene hard boundary conditions."""
