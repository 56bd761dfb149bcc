"""Port of pilosa_tpu/storage: so far only the write request (txn.py)."""
