"""`python -m ssw_tpu_torch …` runs the ssw_test-compatible CLI."""

import sys

from ssw_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
