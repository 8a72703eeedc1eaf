"""Passive density transport and the Taylor-Green error metric."""
