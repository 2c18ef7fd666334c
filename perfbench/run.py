"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``perfbench/harness.py``.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout and its port, in place of this script's own folder
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from perfbench.harness import main
    sys.exit(main(t_start=T_START))
