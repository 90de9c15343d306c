"""``python -m ray_shuffling_data_loader_tpu_torch.analysis`` entry
point."""

import sys

from ray_shuffling_data_loader_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
