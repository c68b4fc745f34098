"""The benchmark's tests import it as the package ``portbench`` from the
checkout's root, as run.py does."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
