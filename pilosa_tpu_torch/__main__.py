"""``python -m pilosa_tpu_torch`` — the CLI entry point (reference:
cmd/featurebase/main.go:16)."""

import sys

from pilosa_tpu_torch.ctl import main

if __name__ == "__main__":
    sys.exit(main())
