"""Port of pilosa_tpu/ingest: so far the ID allocator (idalloc.py)."""
