"""Port of pilosa_tpu/pql (see the package docstring)."""
