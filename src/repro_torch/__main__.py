"""``python -m repro_torch``: the port's universal compression command line
(see ``repro_torch.cli``)."""
import sys

from repro_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
