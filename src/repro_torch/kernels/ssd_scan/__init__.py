from .ops import ssd_scan, ssd_scan_bwd
from .ref import ssd_chunk_states_ref, ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["ssd_chunk_states_ref", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref",
           "ssd_scan_ref"]
