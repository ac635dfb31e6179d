"""The benchmark's own tests: ``python -m pytest bench_port/tests -q`` from the
repo root (CPU); the ``gpu``-marked ones run on the card and skip here."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
