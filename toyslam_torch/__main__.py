"""``python -m toyslam_torch`` entry point."""

import sys

from toyslam_torch.app import main

sys.exit(main())
