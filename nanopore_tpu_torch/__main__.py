import sys

from nanopore_tpu_torch.cli import main

sys.exit(main())
