"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from
the repository root (``-m cuda`` on a machine with the card)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
