"""`python -m repro_torch.analysis` -> mce_lint CLI."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
