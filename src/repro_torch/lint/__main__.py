"""Entry point: `python -m repro_torch.lint [paths...]`."""
import sys

from repro_torch.lint.cli import main

sys.exit(main())
