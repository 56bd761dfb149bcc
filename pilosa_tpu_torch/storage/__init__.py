"""Port of pilosa_tpu/storage: the WAL (wal.py), fragment snapshots
(store.py), the roaring codec (roaring.py), kill points and checkpoint
metadata (recovery.py) and write requests (txn.py)."""
