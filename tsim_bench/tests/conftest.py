"""The benchmark's own tests: `python -m pytest tsim_bench/tests -q -n 0
-p no:cacheprovider` from the repository's root (CPU; tests marked
`cuda` need the card and skip without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
