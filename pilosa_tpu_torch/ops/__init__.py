"""Port of pilosa_tpu/ops (see the package docstring)."""
