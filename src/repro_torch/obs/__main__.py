"""`python -m repro_torch.obs report <trace.jsonl> [--json]` renders
telemetry; see report.py."""
import sys

from repro_torch.obs.report import main

sys.exit(main())
