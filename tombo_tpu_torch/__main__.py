"""``python -m tombo_tpu_torch``: the command line."""
import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
