"""The harness's modules import one another by their file names, as
``run.py`` sets them up; the tests put the harness's folder and the
repository's root on the path the same way."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU (runs the cell on the card)')
