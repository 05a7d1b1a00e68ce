"""``python -m fealess <action> ...`` — the CLI entry point
(reference: the FEALESS binary, test/main.cpp:14-76)."""

import sys

from fealess.apps.cli import main

if __name__ == "__main__":
    sys.exit(main())
