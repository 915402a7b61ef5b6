"""Entry point: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""

import time

T_START = time.monotonic()  # set-up is timed from here

if __name__ == "__main__":
    import sys

    from portbench.harness import main

    sys.exit(main(T_START))
