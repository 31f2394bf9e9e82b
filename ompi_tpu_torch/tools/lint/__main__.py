"""``python -m ompi_tpu_torch.tools.lint`` entry point."""

import sys

from ompi_tpu_torch.tools.lint import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
