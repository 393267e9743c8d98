"""``python -m repro_torch.store`` — the store ingest CLI (writer.main)."""

import sys

from repro_torch.store.writer import main

if __name__ == "__main__":
    sys.exit(main())
