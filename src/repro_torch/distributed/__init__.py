# Multi-device support of the port: so far the gradient compression's
# numerics (int8 quantisation with error feedback).
from .compress import compress_decompress, compress_with_feedback

__all__ = ["compress_decompress", "compress_with_feedback"]
