"""Closed-form boundary queries (the Taylor-Green box)."""
