"""python -m blaze_tpu_torch.bench: the benchmark's runners (runners.main)."""
import sys

from .runners import main

sys.exit(main())
