"""``python -m xpic_tpu_torch config.json``: see ``runtime/cli.py``."""

import sys

from .runtime.cli import main

if __name__ == "__main__":
    sys.exit(main())
