"""Prefix each line of standard input with the seconds since the first read,
so a run's output shows when each phase began:

    python3 -u chip_smoke.py 2>&1 | python3 tools/line_times.py > run.log
"""
import sys
import time

t0 = time.time()
for line in sys.stdin:
    print(f"{time.time() - t0:8.1f} {line}", end="", flush=True)
