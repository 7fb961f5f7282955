"""Crash-kill victim entry point (subprocess target -- see ``crashkill.py``).

    python -m repro_torch.reliability._victim SCENARIO WORKDIR [DEVICE]

Runs one scenario in *this* process, on ``DEVICE`` (``cuda`` unless given),
with the fault plan from the ``REPRO_FAULT_PLAN`` environment variable armed.
A ``kill`` rule terminates the process with a real ``SIGKILL``
mid-operation; a ``record`` plan instead completes cleanly and writes the
enumerated kill sites for the harness.
"""
from __future__ import annotations

import sys


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(
            "usage: python -m repro_torch.reliability._victim SCENARIO WORKDIR [DEVICE]",
            file=sys.stderr,
        )
        return 2
    from .crashkill import run_victim

    run_victim(*argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
