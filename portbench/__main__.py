"""``python3 -m portbench``: see :mod:`portbench.run`."""

import time

T0 = time.perf_counter()  # set-up is timed from here, torch's import in it

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
