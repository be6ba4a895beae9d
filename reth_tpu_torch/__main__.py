"""``python -m reth_tpu_torch <command> ...``: the port's CLI (``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
