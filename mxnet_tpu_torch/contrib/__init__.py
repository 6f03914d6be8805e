"""``mx.contrib`` of the PyTorch port: ``quantization._trace_block``, the
tracer the image-classification example builds its networks with.  The
rest of the JAX package's ``contrib`` waits for ROADMAP Queue 1 item 11.
"""

from . import quantization

__all__ = ["quantization"]
