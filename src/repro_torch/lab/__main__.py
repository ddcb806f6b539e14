"""``python -m repro_torch.lab`` — see :mod:`repro_torch.lab.cli`."""

import sys

from .cli import main

# guarded, unlike a bare sys.exit(main()): importing this module (as a walk
# over the package does) must not run the CLI; ``python -m`` still does
if __name__ == "__main__":
    sys.exit(main())
