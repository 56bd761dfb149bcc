"""Port of pilosa_tpu/parallel (see the package docstring)."""
