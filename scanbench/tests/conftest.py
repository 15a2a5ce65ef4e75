"""The benchmark's own CPU tests (``python -m pytest scanbench/tests``
from the checkout's root); they start the program's scan server on the
CPU where a test drives a whole run."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
