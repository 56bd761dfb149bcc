"""Port of pilosa_tpu/core (see the package docstring)."""
