from .ops import ssd_scan
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_ref"]
