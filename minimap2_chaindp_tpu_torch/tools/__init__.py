"""Companion tooling (the reference's misc/ directory): paftools."""
