from . import ops, ref
from .kernel import ssd_scan
